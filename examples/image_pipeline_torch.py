"""The paper's Fig-3 scenario as a live pipeline, on the PyTorch port:
CIFAR-like images stored as .ra shards, mmap-read, dequantized on the card
by the ``dequant_u8`` CUDA kernel, feeding a step — versus the same data
stored as PNG files. The twin of ``examples/image_pipeline.py``.

    PYTHONPATH=src python examples/image_pipeline_torch.py               # the card
    PYTHONPATH=src python examples/image_pipeline_torch.py --device cpu  # the plain decode
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=2000, help="images")
    p.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    from repro_torch.data import RaDataset, make_image_dataset
    from repro_torch.data.device_loader import resolve_device
    from repro_torch.formats import png
    from repro_torch.kernels.ops import dequant_u8

    device = resolve_device(args.device)
    n, batch = args.n, 256
    with tempfile.TemporaryDirectory(prefix="ra_imgpipe_") as d:
        root = make_image_dataset(os.path.join(d, "ds"), kind="cifar", n=n)
        ds = RaDataset(root)

        # write the PNG mirror (the common deep-learning layout the paper measures)
        png_dir = os.path.join(d, "png")
        os.makedirs(png_dir)
        imgs = ds.rows(0, n)["image"]
        for i in range(n):
            png.write(os.path.join(png_dir, f"{i:06d}.png"), imgs[i])

        scale = torch.full((3,), 1.0 / 255.0, dtype=torch.float32, device=device)
        bias = torch.full((3,), -0.5, dtype=torch.float32, device=device)

        def step(x_u8: np.ndarray) -> float:
            x = torch.from_numpy(np.ascontiguousarray(x_u8)).to(device)
            x = dequant_u8(x.reshape(-1, 3), scale, bias).reshape(x.shape)
            return float(torch.mean(x * x))  # stand-in compute; waits for the device

        # --- RawArray path: mmap rows -> device -----------------------------
        t0 = time.perf_counter()
        acc_ra = 0.0
        for lo in range(0, n, batch):
            acc_ra += step(ds.rows(lo, lo + batch)["image"])
        t_ra = time.perf_counter() - t0

        # --- PNG path: decode every file -> device --------------------------
        t0 = time.perf_counter()
        acc_png = 0.0
        for lo in range(0, n, batch):
            xs = np.stack([png.read(os.path.join(png_dir, f"{i:06d}.png"))
                           for i in range(lo, min(lo + batch, n))])
            acc_png += step(xs)
        t_png = time.perf_counter() - t0

    print(f"images: {n}  batch: {batch}  device: {device}")
    print(f"ra pipeline : {t_ra:.3f}s  ({n/t_ra:,.0f} img/s)")
    print(f"png pipeline: {t_png:.3f}s  ({n/t_png:,.0f} img/s)")
    print(f"speedup     : {t_png/t_ra:.1f}x  (paper reports 6-18x vs libpng)")
    if acc_ra != acc_png:  # the same images through the same decode
        raise SystemExit(f"the ra and png pipelines differ: {acc_ra} != {acc_png}")


if __name__ == "__main__":
    main()
