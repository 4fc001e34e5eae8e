"""Compare two rendered images (EXR or PNG): PSNR and max abs diff (the
JAX package's ``tools/compare_renders.py``).

    python -m renderformer_tpu_torch.tools.compare_renders a.exr b.exr [--peak 1.0]

EXR is read by ``io/image.read_exr``, PNG by ``io/image.read_png`` (cv2)
as float32 / 255.  The peak defaults to max|a|.  Exit code 1 on a shape
mismatch.
"""

import argparse
import sys

import numpy as np


def load(path: str) -> np.ndarray:
    from renderformer_tpu_torch.io.image import read_exr, read_png
    if path.endswith('.exr'):
        return read_exr(path)
    return np.asarray(read_png(path), np.float32) / 255.0


def compare(a: np.ndarray, b: np.ndarray, peak=None):
    """(psnr, mse, peak, max|a - b|) of two images of one shape."""
    mse = float(np.mean((a - b) ** 2))
    peak = peak or max(float(np.abs(a).max()), 1e-6)
    psnr = float('inf') if mse == 0 else 10 * np.log10(peak ** 2 / mse)
    return psnr, mse, peak, float(np.abs(a - b).max())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('a')
    p.add_argument('b')
    p.add_argument('--peak', type=float, default=None)
    args = p.parse_args(argv)
    a, b = load(args.a), load(args.b)
    if a.shape != b.shape:
        print(f'shape mismatch: {a.shape} vs {b.shape}')
        return 1
    psnr, mse, peak, diff = compare(a, b, args.peak)
    print(f'PSNR: {psnr:.2f} dB  (mse={mse:.3e}, peak={peak:.3f}, max|diff|={diff:.3e})')
    return 0


if __name__ == '__main__':
    sys.exit(main())
