#!/usr/bin/env python
"""Block size of the batched 3x3 eigh in postproc.compute_principal_stress.

torch.linalg.eigh on a CUDA batch of 3x3 float64 matrices goes to
cuSOLVER's batched solver, which refuses batches above some size.  For
each candidate block this script decomposes the same seeded batch of
symmetric matrices (as many as a 983,040-tet frame holds) in blocks of
that size on the card, and records whether every call was taken, the
milliseconds of the whole batch (CUDA events, the best of 3 after one
warm-up) and the largest difference from the CPU's eigenvalues.  A final
run at the smallest block shows that a refusal left the card usable.

Usage:  python tools/eigh_block_probe.py [--n 983040] [--out FILE]
Prints the card's name and power limit, one line per block, and the
records as one JSON object on the last line (also written to --out).
"""
import argparse
import json
import subprocess
import sys

BLOCKS = (1024, 2048, 4096, 8192, 12288, 16384, 20480, 24576, 28672,
          30720, 32767, 32768)


def batch(n, seed):
    """n symmetric 3x3 float64 matrices: a pressure-sized diagonal and
    deviatoric parts three orders smaller, as stresses are."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, 3, 3)) * 1e5
    a = 0.5 * (a + a.transpose(0, 2, 1))
    a += (rng.uniform(-1e8, 0, n))[:, None, None] * np.eye(3)
    return a


def blocked(s, block, w, v):
    import torch

    for k in range(0, len(s), block):
        w[k:k + block], v[k:k + block] = torch.linalg.eigh(s[k:k + block])


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=983040)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("eigh_block_probe: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card)
    host = torch.as_tensor(batch(a.n, 17))
    ref = torch.linalg.eigvalsh(host)
    s = host.cuda()
    w = torch.empty((a.n, 3), dtype=torch.float64, device="cuda")
    v = torch.empty_like(s)
    rec = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "n": a.n, "blocks": []}
    for block in BLOCKS + (BLOCKS[0],):
        r = {"block": block, "calls": -(-a.n // block)}
        try:
            blocked(s, block, w, v)
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                blocked(s, block, w, v)
                e1.record()
                torch.cuda.synchronize()
                times.append(e0.elapsed_time(e1))
            r["ok"] = True
            r["ms"] = min(times)
            r["max_abs_err_of_max"] = float(
                (w.cpu() - ref).abs().max() / ref.abs().max())
        except RuntimeError as e:
            r["ok"] = False
            r["error"] = str(e).splitlines()[0][:200]
        rec["blocks"].append(r)
        print(json.dumps(r), flush=True)
    line = json.dumps(rec)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
