#!/usr/bin/env python3
"""The step time of one training cell from several checkouts, run in turn
on one NVIDIA GPU: the way to set two versions of the port side by side
within one machine (a card's power limit and clocks differ between
machines).

    python3 scripts/train_ab.py build/parent . . build/parent -- \\
        --arch qwen3-0.6b --layers 4 --workers 2 --batch-per-worker 4 \\
        --seq 256 --buckets 4 --steps 6 --use-kernels

Each tree runs ``python -m repro_torch.launch.train`` with the arguments
after ``--``, its own ``src/`` on ``PYTHONPATH``, in a process of its own
(TF32 as the launcher leaves it), and writes the launcher's metrics to a
temporary file.  Prints, per run, the median of the step-to-step walls
from step 2 on (the first two steps compile and warm the allocator), the
losses, and the card's name and power limit; the runs of one tree are
summarised last.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]


def run(tree: Path, argv: list) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp, "metrics.json")
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *argv, "--log-every", "1", "--metrics-out",
                        str(out)], cwd=tree, env=env, check=True,
                       stdout=subprocess.DEVNULL)
        hist = json.loads(out.read_text())["history"]
    walls = [h["wall_s"] for h in hist]
    return {"step_ms": 1e3 * statistics.median(
                b - a for a, b in zip(walls[1:], walls[2:])),
            "losses": [h["loss"] for h in hist]}


def main() -> int:
    if "--" not in sys.argv:
        print(__doc__, file=sys.stderr)
        return 2
    cut = sys.argv.index("--")
    trees, argv = [Path(t).resolve() for t in sys.argv[1:cut]], \
        sys.argv[cut + 1:]
    smi, by_tree = card(), {}
    for tree in trees:
        r = run(tree, argv)
        by_tree.setdefault(str(tree), []).append(r["step_ms"])
        print(f"[ab] {tree}: step {r['step_ms']:.3f} ms (median of the "
              f"walls from step 2), losses {r['losses']} [{smi}]",
              flush=True)
    print(json.dumps({"card": smi, "step_ms": by_tree}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
