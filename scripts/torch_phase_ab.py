#!/usr/bin/env python3
"""Time chip_smoke.py phases of two checkouts on one GPU, in turns.

    python scripts/torch_phase_ab.py --parent build/parent [--tree .] \
        [--out build/phase_ab] --phase rwkv6_kernel_phase --phase compression_phase ...

Runs the parent checkout, this one, this one again and the parent again,
each in a process of its own started in its own tree: the tree's CUDA
kernels are built, then the named phases of its ``chip_smoke.py`` are
called in the order given and each one's seconds printed
(``chip_smoke.phase``); a phase the tree does not have is skipped. A
phase's arguments are found by their names: ``torch``, ``np``,
``card_line``, ``summary`` (a fresh dict) and the port's ops modules
(``gla_cuda``, ``rwkv6_cuda``, ``mamba_cuda``). Each run's full output
goes to ``<out>/phase_ab_<label>.log``; the summary lines are printed.
Make the parent with ``git archive <commit> | tar -x -C build/parent``.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def one(tree: str, label: str, phases) -> None:
    """Run ``phases`` of ``tree``'s chip_smoke.py in this process."""
    import inspect

    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from lina_speech_tpu_torch.ops import _build, gla_cuda, mamba_cuda, rwkv6_cuda

    assert os.path.dirname(os.path.abspath(cs.__file__)) == tree, cs.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = cs.card()
    print(f"== {label} ({tree}) [{card_line}]", flush=True)
    cs.SFU_RATE = cs.sfu_rate(torch)
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    print(f"{label}: build {time.perf_counter() - t0:.1f} s", flush=True)
    known = dict(torch=torch, np=np, card_line=card_line, gla_cuda=gla_cuda,
                 rwkv6_cuda=rwkv6_cuda, mamba_cuda=mamba_cuda)
    for name in phases:
        fn = getattr(cs, name, None)
        if fn is None:
            print(f"{label}: no {name} in this tree", flush=True)
            continue
        args = [{} if p == "summary" else known[p]
                for p, v in inspect.signature(fn).parameters.items()
                if v.default is inspect.Parameter.empty]
        cs.phase(fn, *args)
    print(f"{label}: " + ", ".join(f"{n} {s:.1f}" for n, s in cs.PHASE_SECONDS)
          + f"; total {sum(s for _, s in cs.PHASE_SECONDS):.1f} s [{card_line}]", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the parent checkout")
    ap.add_argument("--tree", default=".", help="this checkout")
    ap.add_argument("--out", default="build/phase_ab", help="directory of the full logs")
    ap.add_argument("--phase", action="append", required=True,
                    help="a chip_smoke.py phase to time (repeat for more, in order)")
    ap.add_argument("--one", nargs=2, metavar=("TREE", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(*args.one, args.phase)
        return
    if not args.parent:
        ap.error("--parent is required")
    os.makedirs(args.out, exist_ok=True)
    script = os.path.abspath(__file__)
    for tree, label in ((args.parent, "parent1"), (args.tree, "change1"),
                        (args.tree, "change2"), (args.parent, "parent2")):
        log = os.path.join(args.out, f"phase_ab_{label}.log")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, script, "--one", tree, label,
                                 *(a for p in args.phase for a in ("--phase", p))],
                                stdout=f, stderr=subprocess.STDOUT).returncode
        lines = open(log).read().splitlines()
        if rc:
            print("\n".join(lines[-30:]))
            raise SystemExit(f"{label} failed with exit code {rc}")
        print("\n".join(ln for ln in lines if ln.startswith(f"{label}: ")), flush=True)


if __name__ == "__main__":
    main()
