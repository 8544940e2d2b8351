"""Training launcher: ``python -m repro_torch.launch.train --arch paper_lm ...``

Thin CLI over ``repro_torch.train.loop`` — builds the RawArray token dataset
if absent, constructs the model (random weights from ``--seed``) and the
loader, and runs the fault-tolerant loop (auto-resume from
``<workdir>/ckpt``). Runs on the current CUDA device unless ``--device``
names another (``--device cpu`` on a host without a card).
"""

from __future__ import annotations

import argparse
import os


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="paper_lm")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--workdir", default="runs/train")
    p.add_argument("--dataset", default=None, help="existing RaDataset dir")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fresh", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the current CUDA device)")
    p.add_argument(
        "--device-feed", action="store_true",
        help="wrap the loader in DeviceLoader (DESIGN.md §12): keep "
             "RA_DEVICE_BUFS batches resident on the device, overlapping host "
             "read + H2D with the train step; quantized fields decode "
             "on the device via the dequant_u8 CUDA kernel",
    )
    p.add_argument(
        "--device-bufs", type=int, default=None,
        help="device-resident batch depth (default: RA_DEVICE_BUFS or 2)",
    )
    p.add_argument(
        "--restore", choices=("pipelined", "naive"), default="pipelined",
        help="resume restore path (DESIGN.md §13): 'pipelined' overlaps "
             "read/decode/H2D/dequant under the RA_COLDSTART_INFLIGHT "
             "budget; 'naive' is the phase-by-phase baseline",
    )
    p.add_argument(
        "--mesh-hosts", default=None,
        help="data-mesh membership (DESIGN.md §15): comma-separated host "
             "names, one process per host, listed in process-rank order "
             "(default: RA_MESH_HOSTS)",
    )
    p.add_argument(
        "--mesh-host", default=None,
        help="this process's mesh host name (default: RA_MESH_HOST)",
    )
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """Parse the CLI, and build its data mesh as ``args.mesh``: from
    ``--mesh-hosts``/``--mesh-host`` (both or neither), else from
    ``RA_MESH_HOSTS``/``RA_MESH_HOST``, else None."""
    from repro_torch.distributed.data_mesh import DataMesh

    p = _parser()
    args = p.parse_args(argv)
    # data mesh (DESIGN.md §15): shard-ownership ingest across processes
    if args.mesh_hosts or args.mesh_host:
        names = [h.strip() for h in (args.mesh_hosts or "").split(",") if h.strip()]
        if not names or not args.mesh_host:
            p.error("--mesh-hosts and --mesh-host must be given together")
        args.mesh = DataMesh(args.mesh_host, names)
    else:
        args.mesh = DataMesh.from_env()  # RA_MESH_HOSTS / RA_MESH_HOST, else None
    return args


def run(args: argparse.Namespace) -> dict:
    """Train as ``args`` (from :func:`parse_args`) say; returns
    ``repro_torch.train.train``'s summary."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataLoader, RaDataset, make_token_dataset
    from repro_torch.data.device_loader import resolve_device
    from repro_torch.distributed.optimizer import AdamWConfig
    from repro_torch.models import build_model
    from repro_torch.train import TrainLoopConfig, train

    cfg = get_config(args.arch)
    device = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    ds_root = args.dataset or os.path.join(args.workdir, "dataset")
    if not os.path.exists(os.path.join(ds_root, "manifest.json")):
        make_token_dataset(ds_root, n_docs=2048, seq_len=min(256, cfg.max_seq),
                           vocab=cfg.vocab, shard_rows=256)
    # reuse_buffers is safe: the step copies each batch to the device (or to
    # int64 ids) before asking for the next; with --device-feed the
    # DeviceLoader's feeder confirms each transfer before recycling the ring
    loader = DataLoader(RaDataset(ds_root), args.batch, seed=args.seed,
                        reuse_buffers=True, mesh=args.mesh)
    if args.device_feed:
        from repro_torch.data import DeviceLoader

        loader = DeviceLoader(loader, bufs=args.device_bufs, device=device)
    return train(
        build_model(cfg, device=device, seed=args.seed),
        loader,
        TrainLoopConfig(
            steps=args.steps,
            ckpt_every=args.ckpt_every,
            ckpt_dir=os.path.join(args.workdir, "ckpt"),
            adamw=AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=max(args.steps, 200)),
        ),
        resume=not args.fresh,
        restore_mode=args.restore,
    )


def main(argv=None) -> int:
    out = run(parse_args(argv))
    print(f"done: steps={out['steps']} wall={out['wall_s']:.1f}s preempted={out['preempted']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
