"""The inputs of ``tests/test_torch_moe_ep.py``, shared with its gloo rank
subprocesses (which import no JAX): a reduced DeepSeek-V3 MoE config at a
capacity factor, and each shard's tokens, weights and cotangent from a
numpy seed."""

import dataclasses

import numpy as np

AUX_WEIGHT = 0.7
CAPACITY = {"no_drops": 8.0, "drops": 0.5}
TL = 24  # tokens a shard


def cut(cfg, capacity: float):
    """``cfg`` at ``capacity``, one dispatch chunk."""
    return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity, dispatch_chunks=1))


def inputs(n, seed, d, E, ffe):
    """x (n, TL, d), router (d, E), w_gate/w_up (E, d, ffe), w_down (E, ffe, d),
    and a cotangent for y, all f32."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"x": f(n, TL, d), "router": f(d, E, scale=0.3), "w_gate": f(E, d, ffe, scale=d ** -0.5),
            "w_up": f(E, d, ffe, scale=d ** -0.5), "w_down": f(E, ffe, d, scale=ffe ** -0.5),
            "ct": f(n, TL, d)}


def ffn_params(d, E, f, seed=5):
    """A full MoE FFN's weights (router, experts, the shared expert) and its
    random generator, for ``moe_ffn_ep`` as a model calls it."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)) * 0.3,
         "w_gate": rng.standard_normal((E, d, f)) * d ** -0.5,
         "w_up": rng.standard_normal((E, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((E, f, d)) * f ** -0.5,
         "shared_gate": rng.standard_normal((d, f)) * d ** -0.5,
         "shared_up": rng.standard_normal((d, f)) * d ** -0.5,
         "shared_down": rng.standard_normal((f, d)) * f ** -0.5}
    return {k: v.astype(np.float32) for k, v in p.items()}, rng
