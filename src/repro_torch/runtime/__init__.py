"""Runtime services: fault tolerance, straggler mitigation, elastic scaling,
fault injection, and the event-driven cluster-membership controller; the
port of ``repro/runtime``, exporting what it exports."""
from repro_torch.runtime.elastic import (ElasticContext,  # noqa: F401
                                         HostTopology, SimHost,
                                         grow_devices, shrink_devices)
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop  # noqa: F401
from repro_torch.runtime.faults import (CrashStep, DriftHost,  # noqa: F401
                                        FaultInjector, JoinHost, Preemption,
                                        SimClock, SlowHost, SpotPreemption)
from repro_torch.runtime.straggler import (  # noqa: F401
    HostStragglerAggregator, StragglerMonitor)
# controller imports the siblings above, so it goes last (no cycle: none of
# elastic/faults/straggler import it back)
from repro_torch.runtime.controller import (  # noqa: F401
    CalibrationConfig, ClusterController, ClusterEvent, DriftSource,
    DriftSustained, ElasticConfig, HostJoin, HostLost, IllegalTransition,
    InjectorSource, MembershipChange, MembershipStateMachine,
    PreemptionWarning, StragglerSource, StragglerSustained)
