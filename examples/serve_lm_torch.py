"""Serve a trained checkpoint with batched decode requests, on the PyTorch
port. The twin of ``examples/serve_lm.py``, a thin front of
``python -m repro_torch.serving``.

    PYTHONPATH=src python examples/serve_lm_torch.py            # train_lm_torch's ckpt
    PYTHONPATH=src python examples/serve_lm_torch.py --random   # random weights
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The checkpoint's leaves stream from the RawArray files to the device
through the pipelined cold start (header parse, pinned reads, upload), so
cold-start latency is checkpoint read latency.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "ra_train_lm_torch"))
    p.add_argument("--arch", default="paper_lm")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--random", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    from repro_torch.serving.__main__ import main as serve

    cli = ["--workdir", args.workdir, "--arch", args.arch, "--batch", str(args.batch),
           "--prompt", "16", "--max-new", str(args.max_new), "--seed", "0"]
    if args.random:
        cli.append("--random")
    if args.device:
        cli += ["--device", args.device]
    serve(cli)


if __name__ == "__main__":
    main()
