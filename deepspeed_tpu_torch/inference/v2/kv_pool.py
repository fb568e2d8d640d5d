"""KV-pool byte accounting: pool dtypes, bytes-per-block, budget sizing.

One shared source of truth for "how big is a KV block" so the engine
(allocating the pools), the serve CLI (sizing ``num_blocks`` from a byte
budget), the driver (health/metrics) and the capacity tests cannot drift.

Layout recap (engine_v2): each of K and V is [L, num_blocks+1, block_size,
kv_heads, head_dim] in the payload dtype; ``int8`` mode adds a per-token-row
per-kv-head fp32 scale plane [L, num_blocks+1, block_size, kv_heads] per
pool (quantize_kv's per-vector granularity — see ops/quantizer/block_quant).
A "block" here is one (block_size, kv_heads, head_dim) slab counted across
all L layers and BOTH pools, i.e. the unit ``free_blocks`` admission counts.

At head_dim=128 the int8 ratio is 2*128/(128+4) ≈ 1.94x — the ≥1.9x
capacity bar the acceptance tests pin.
"""

from typing import Any, Dict, Tuple

import numpy as np

# payload bytes per element + scale bytes per head vector
KV_DTYPES = ("bf16", "int8")

# plane name -> ((n_layers, *per_block_tail), dtype) — the exact-contract
# spec ``check_kv_payload`` validates against (engine_v2._kv_payload_spec
# builds it from the live pools)
KVPayloadSpec = Dict[str, Tuple[tuple, Any]]


def check_kv_payload(spec: KVPayloadSpec, n: int, payload: Dict,
                     context: str = "import_kv_blocks") -> None:
    """ONE strict payload contract for every path that moves KV blocks
    between pools — handoff import (all transports), host-tier readmit,
    and router peer pulls validate here instead of keeping drifting
    copies. Raises loudly on any mismatch BEFORE a scatter: a malformed
    payload (wrong dtype, wrong trailing dims, missing or stray scale
    planes) must never silently cast-and-scatter garbage into live KV.

    ``spec`` maps each required plane to ``((n_layers, *per_block_tail),
    dtype)``; ``payload[name]`` must be ``[n_layers, n, *per_block_tail]``
    in exactly that dtype."""
    missing = sorted(set(spec) - set(payload))
    extra = sorted(set(payload) - set(spec))
    if missing or extra:
        raise ValueError(
            f"{context}: payload planes {sorted(payload)} do not "
            f"match the pool's {sorted(spec)}"
            + (f"; missing {missing}" if missing else "")
            + (f"; unexpected {extra}" if extra else "")
        )
    for name, (block_shape, dtype) in spec.items():
        plane = payload[name]
        expect = (block_shape[0], n) + tuple(block_shape[1:])
        if tuple(plane.shape) != expect:
            raise ValueError(
                f"{context}: payload[{name!r}] shape "
                f"{tuple(plane.shape)} != {expect} expected for {n} "
                f"target blocks"
            )
        if np.dtype(plane.dtype) != np.dtype(dtype):
            raise ValueError(
                f"{context}: payload[{name!r}] dtype "
                f"{np.dtype(plane.dtype)} != pool dtype "
                f"{np.dtype(dtype)} (a silent cast would corrupt "
                "quantized codes/scales)"
            )


def _check_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_cache_dtype={kv_dtype!r}: expected one of {KV_DTYPES} "
            "(bf16 = pool in the engine compute dtype, int8 = quantized "
            "payload + fp32 per-vector scale plane)"
        )
    return kv_dtype


def bytes_per_block(block_size: int, kv_heads: int, head_dim: int,
                    n_layers: int, kv_dtype: str = "bf16") -> int:
    """HBM bytes one logical KV block costs across all layers and both
    (K and V) pools — payload plus, for int8, the fp32 scale plane."""
    _check_dtype(kv_dtype)
    vectors = block_size * kv_heads  # head vectors per block per pool
    if kv_dtype == "int8":
        per_pool = vectors * head_dim * 1 + vectors * 4  # int8 payload + fp32 scale
    else:
        per_pool = vectors * head_dim * 2  # bf16 payload
    return 2 * n_layers * per_pool


def blocks_for_budget(budget_bytes: int, block_size: int, kv_heads: int,
                      head_dim: int, n_layers: int,
                      kv_dtype: str = "bf16") -> int:
    """How many pool blocks fit a fixed byte budget (the +1 trash block is
    charged too, so the returned count is directly ``num_blocks``)."""
    per = bytes_per_block(block_size, kv_heads, head_dim, n_layers, kv_dtype)
    n = budget_bytes // per - 1  # -1: the engine allocates num_blocks + 1
    if n < 1:
        raise ValueError(
            f"kv pool budget {budget_bytes} bytes holds no blocks at "
            f"{per} bytes/block (block_size={block_size}, kv_heads={kv_heads}, "
            f"head_dim={head_dim}, n_layers={n_layers}, dtype={kv_dtype})"
        )
    return int(n)


def capacity_multiplier(block_size: int, kv_heads: int, head_dim: int,
                        kv_dtype: str = "bf16") -> float:
    """Effective pool-capacity multiplier of ``kv_dtype`` vs the bf16
    baseline at a fixed byte budget (layer count cancels)."""
    base = bytes_per_block(block_size, kv_heads, head_dim, 1, "bf16")
    cur = bytes_per_block(block_size, kv_heads, head_dim, 1, kv_dtype)
    return base / cur


def pool_bytes(num_blocks: int, block_size: int, kv_heads: int,
               head_dim: int, n_layers: int, kv_dtype: str = "bf16") -> int:
    """Total HBM bytes of the allocated pools (num_blocks + 1 trash)."""
    return (num_blocks + 1) * bytes_per_block(
        block_size, kv_heads, head_dim, n_layers, kv_dtype
    )


def describe(num_blocks: int, block_size: int, kv_heads: int, head_dim: int,
             n_layers: int, kv_dtype: str = "bf16") -> Dict:
    """The health()/metrics snapshot: bytes, dtype, capacity multiplier."""
    return {
        "kv_cache_dtype": _check_dtype(kv_dtype),
        "kv_pool_bytes": pool_bytes(
            num_blocks, block_size, kv_heads, head_dim, n_layers, kv_dtype),
        "kv_bytes_per_block": bytes_per_block(
            block_size, kv_heads, head_dim, n_layers, kv_dtype),
        "kv_capacity_multiplier": capacity_multiplier(
            block_size, kv_heads, head_dim, kv_dtype),
    }
