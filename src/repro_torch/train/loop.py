"""The training loop: RawArray data in, RawArray checkpoints out. The torch
twin of the JAX package's ``train/loop.py``.

Fault-tolerance contract (DESIGN.md §3):

* periodic async checkpoints (params + optimizer + loader state) via the
  atomic-publish RawArray store;
* SIGTERM/SIGINT → synchronous checkpoint-and-exit (preemption-safe);
* ``train(..., resume=True)`` restores the latest checkpoint INCLUDING the
  data-iterator position (exact-once sample order), through the pipelined
  cold start (or the naive one);
* per-step wall-time EWMA + outlier log = straggler monitor.

Two departures from the JAX package: the model comes with its weights (the
port's model owns its parameters; a resume overwrites them in place), and
the loop runs on ``model.device``. A step is eager: ``train_loss`` with
autograd, ``backward``, then ``optimizer.apply_updates`` in place. A mesh
feed's global ``DTensor`` batch trains on this process's block with the
gradients averaged over the mesh (see :func:`make_step`), as the JAX
package's jitted step trains on a global array across processes.
"""

from __future__ import annotations

import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..checkpoint import CheckpointManager, ColdStartStats, restore_naive, restore_pipelined
from ..data import LoaderState
from ..distributed import optimizer as optim


@dataclass
class TrainLoopConfig:
    steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 2.5  # step slower than factor x EWMA -> flag
    adamw: optim.AdamWConfig = field(default_factory=optim.AdamWConfig)


def _copy_into(dst: Any, src: Any) -> None:
    """Write restored leaves into the model's parameters, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


def _local_batch(batch: Dict[str, Any]) -> Tuple[Dict[str, Any], Any]:
    """A batch as the step takes it, and the process group its global
    ``DTensor`` fields span (None for a plain batch or a mesh of one): this
    process's block of a mesh feed's batch, which in a world of one is the
    whole batch."""
    from torch.distributed.tensor import DTensor

    meshes = [v.device_mesh for v in batch.values() if isinstance(v, DTensor)]
    if not meshes:
        return batch, None
    local = {k: v.to_local() if isinstance(v, DTensor) else v for k, v in batch.items()}
    return local, (meshes[0].get_group() if meshes[0].size() > 1 else None)


def _mean_over(group: Any, tensors: List[torch.Tensor]) -> None:
    """Replace each tensor by its mean over ``group``'s processes, in place."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    for t in tensors:
        dist.all_reduce(t, group=group)
        t.div_(n)


def make_step(model, adamw: optim.AdamWConfig) -> Callable:
    """The default step: ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``, with the parameters and the state updated in place and each
    gradient freed once applied.

    A mesh feed's global batch over several processes trains as the JAX
    package's jitted step trains on a global array: the loss is the global
    batch's, so each process takes the gradient of its block's mean and the
    gradients (and the metrics) are averaged over the mesh before the
    update, which then runs alike everywhere (every host's block has the
    same rows and positions, so the mean of the means is the global mean)."""
    def step(params, opt_state, batch):
        batch, group = _local_batch(batch)
        loss, metrics = model.train_loss(batch)
        loss.backward()
        grads = optim.tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p), params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group is not None:
            metrics = {k: v.clone() for k, v in metrics.items()}  # storage of their own
            _mean_over(group, optim.leaves(grads) + list(metrics.values()))
        params, opt_state, info = optim.apply_updates(params, grads, opt_state, adamw)
        for p in optim.leaves(params):
            p.grad = None
        return params, opt_state, {**metrics, **info}

    return step


def train(
    model,
    loader,
    loop_cfg: TrainLoopConfig,
    *,
    resume: bool = True,
    restore_mode: str = "pipelined",
    hooks: Optional[List[Callable[[int, Dict[str, float]], None]]] = None,
) -> Dict[str, Any]:
    """Single-host training driver (the end-to-end example path): trains
    ``model`` in place on the batches of ``loader`` (a ``DataLoader`` or a
    ``DeviceLoader``). Returns a summary."""
    adamw = loop_cfg.adamw
    model.requires_grad_(True)
    params = model.param_tree()
    opt_state = optim.init_state(params, adamw)
    step_fn = make_step(model, adamw)

    cm = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep)
    start_step = 0
    cold_start: Optional[ColdStartStats] = None
    if resume and cm.latest() is not None:
        s = cm.latest()
        # overlapped cold-start restore straight to the device (DESIGN.md §13);
        # restore_mode="naive" keeps the phase-by-phase baseline reachable
        restore_fn = restore_pipelined if restore_mode == "pipelined" else restore_naive
        cold_start = ColdStartStats()
        restored, opt_state, extra = restore_fn(cm.path(s), params, opt_state,
                                                device=model.device, stats=cold_start)
        with torch.no_grad():
            _copy_into(params, restored)
        del restored
        if "loader" in extra:
            loader.restore(LoaderState.from_dict(extra["loader"]))
        start_step = s
        print(f"[train] resumed from step {s}")

    # --- preemption handling (signal handlers live on the main thread) -------
    preempted = {"flag": False}

    def _on_signal(signum, frame):
        preempted["flag"] = True

    old_handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, _on_signal)

    losses: List[float] = []
    step_s: List[float] = []
    ewma = None
    stragglers = 0
    last_state: Optional[LoaderState] = None
    t_train0 = time.perf_counter()
    step = start_step
    try:
        while step < loop_cfg.steps:
            batch = next(loader)
            last_state = batch.pop("_state")
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if ewma is None:
                ewma = dt
            elif dt > loop_cfg.straggler_factor * ewma and step > start_step + 3:
                stragglers += 1
                print(f"[straggler] step {step}: {dt*1e3:.1f}ms vs EWMA {ewma*1e3:.1f}ms")
            ewma = 0.9 * (ewma if ewma else dt) + 0.1 * dt
            losses.append(loss)
            step_s.append(dt)
            step += 1
            if step % loop_cfg.log_every == 0:
                print(
                    f"[train] step {step} loss={loss:.4f} "
                    f"acc={float(metrics.get('acc', 0)):.3f} {dt*1e3:.0f}ms"
                )
            if hooks:
                for h in hooks:
                    h(step, {k: float(v) for k, v in metrics.items()})
            if step % loop_cfg.ckpt_every == 0 or preempted["flag"]:
                cm.save(
                    step, params, opt_state,
                    extra={"loader": last_state.to_dict(), "loss": loss},
                )
            if preempted["flag"]:
                cm.wait()
                print(f"[train] preempted at step {step}; checkpoint flushed")
                break
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
        loader.stop()

    cm.wait()
    wall = time.perf_counter() - t_train0
    if step > start_step and step % loop_cfg.ckpt_every != 0 and not preempted["flag"]:
        cm.save(step, params, opt_state,
                extra={"loader": last_state.to_dict() if last_state else {}})
        cm.wait()
    return {
        "params": params,
        "opt_state": opt_state,
        "losses": losses,
        "step_s": step_s,  # each step's wall time, batch ready to loss on the host
        "cold_start": cold_start,  # the resume's ColdStartStats (None: no resume)
        "steps": step,
        "wall_s": wall,
        "stragglers": stragglers,
        "loader_stats": loader.stats(),
        "ckpt_save_s": cm.save_s,
        "preempted": preempted["flag"],
    }
