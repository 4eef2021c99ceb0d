#!/usr/bin/env python3
"""Time chosen phases of ``chip_smoke.py`` in one or more checkouts, one
after another on the same card, so that two commits are compared on one
machine::

    python3 chip_phases.py --phases 24 26 -- DIR [DIR ...]

Each DIR is the root of a checkout that holds ``chip_smoke.py`` (this one,
or another commit unpacked with ``git archive``); give them in the order
to run, e.g. parent, change, change, parent.  For each, a fresh process
in DIR builds DIR's kernels and runs the phases with DIR's code, printing
their lines and then ``[phases] DIR phase N: S s ok`` (after the card's
name and power limit, as ``nvidia-smi`` gives them); phase 26 first
runs phase 4 (its tokens are phase 26's yardstick) outside the timer.  A
phase that fails is reported and the next one runs.  The last line is
one JSON object: ``{"runs": [{"dir", "phase", "s", "ok"}, ...]}``.  Exits
non-zero where a phase failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: the phases it runs: 3 (the kernel rows of the attention and the loss
#: head: ``check_flash``, ``check_paged``, ``check_flash_bwd``,
#: ``check_xent``), 11 (``train_full``), 19 (``pipeline_interpreter``),
#: 24 (``train_hybrid_zero``), 26 (``serve_tp``), 29
#: (``compressed_blocks``), 30 (``mamba2_train``), 31 (``mamba2_split``),
#: 32 (``moe_engine``), 33 (``dense_rest``), 34 (``jamba``), 35
#: (``hybrid_engine``), 36 (``grok``; its part (d) runs in 24), 37
#: (``multimodal``) and 38 (``elastic``), the same functions in every
#: checkout since they were added (a checkout without one reports that
#: phase failed)
PHASES = ("3", "11", "19", "24", "26", "29", "30", "31", "32", "33", "34",
          "35", "36", "37", "38")

CHILD = r"""
import json, sys, time, traceback
import torch
import chip_smoke as cs
from repro_torch.kernels import build
build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels = cs.kernel_wrappers()
paged4 = None
for ph in sys.argv[1:]:
    t0, ok = time.perf_counter(), True
    try:
        if ph == "3":
            timer = cs.Timer(torch)
            cs.check_flash(torch, timer)
            cs.check_paged(torch, timer)
            cs.check_flash_bwd(torch, timer)
            cs.check_xent(torch, timer)
            del timer
        elif ph == "11":
            cs.train_full(torch, kernels)
        elif ph == "19":
            cs.pipeline_interpreter(torch, kernels)
        elif ph == "24":
            cs.train_hybrid_zero(torch)
        elif ph == "26":
            if paged4 is None:
                paged4 = cs.serve_paged(torch, kernels)[1]
            t0 = time.perf_counter()
            cs.serve_tp(torch, kernels, paged4)
        elif ph == "29":
            cs.compressed_blocks(torch)
        elif ph == "30":
            cs.mamba2_train(torch, kernels)
        elif ph == "31":
            cs.mamba2_split(torch)
        elif ph == "32":
            cs.moe_engine(torch, kernels)
        elif ph == "33":
            cs.dense_rest(torch, kernels)
        elif ph == "34":
            cs.jamba(torch, kernels)
        elif ph == "35":
            cs.hybrid_engine(torch, kernels)
        elif ph == "36":
            cs.grok(torch, kernels)
        elif ph == "37":
            cs.multimodal(torch, kernels)
        elif ph == "38":
            cs.elastic(torch, kernels)
    except Exception:
        traceback.print_exc()
        ok = False
    s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print("[phases] " + json.dumps({"phase": ph, "s": s, "ok": ok}),
          flush=True)
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", nargs="+", choices=PHASES,
                    required=True)
    ap.add_argument("dirs", nargs="+", metavar="DIR")
    args = ap.parse_args()
    print("[card] " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    runs = []
    for d in args.dirs:
        root = os.path.abspath(d)
        if not os.path.isfile(os.path.join(root, "chip_smoke.py")):
            raise SystemExit(f"chip_phases: no chip_smoke.py in {d}")
        proc = subprocess.Popen([sys.executable, "-c", CHILD, *args.phases],
                                cwd=root, stdout=subprocess.PIPE, text=True)
        seen = set()
        for line in proc.stdout:
            if line.startswith("[phases] {"):
                rec = json.loads(line[len("[phases] "):])
                runs.append({"dir": d, **rec})
                seen.add(rec["phase"])
                print(f"[phases] {d} phase {rec['phase']}: {rec['s']:.1f} s "
                      f"{'ok' if rec['ok'] else 'FAILED'}", flush=True)
            else:
                print(line, end="", flush=True)
        proc.wait()
        runs += [{"dir": d, "phase": ph, "s": None, "ok": False}
                 for ph in args.phases if ph not in seen]
    print(json.dumps({"runs": runs}), flush=True)
    if not all(r["ok"] for r in runs):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
