"""Compare two .raw renders (the byte-compatible format of the reference's
internal/app/raw/writer.go) — mean/max absolute difference and PSNR.

    python tools/compare_raw.py a.raw b.raw [--atol 1e-5]

Exit code 0 if the images agree within --atol, 1 otherwise. Useful for
golden-image workflows and for diffing against renders produced by the
reference renderer itself (its experiment.raw uses the same layout).
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from pathtracer.io.raw import read_raw


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--atol", type=float, default=1e-5)
    args = ap.parse_args()

    a = read_raw(args.a)
    b = read_raw(args.b)
    if a.shape != b.shape:
        print(f"shape mismatch: {a.shape} vs {b.shape}")
        return 1
    d = np.abs(a - b)
    mse = float(np.mean((a - b) ** 2))
    psnr = 10 * math.log10(1.0 / mse) if mse > 0 else float("inf")
    print(f"mean|d|={d.mean():.3e} max|d|={d.max():.3e} "
          f"mse={mse:.3e} psnr={psnr:.2f} dB")
    return 0 if d.max() <= args.atol else 1


if __name__ == "__main__":
    sys.exit(main())
