"""The paper's examples on the port (``python -m
repro_torch.examples.<name> [--device cpu]``): ``quickstart`` (Case 1 and
the engine) and ``classification_split`` (Case 2 and the fig-5 headline
from the cost model)."""
