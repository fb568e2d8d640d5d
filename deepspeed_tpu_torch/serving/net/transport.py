"""RemoteTransport: the cross-process KV handoff wire.

Copy of ``deepspeed_tpu/serving/net/transport.py`` over the port's
``InferenceEngineV2``. Its ``export_kv_blocks`` copies the blocks to the
host synchronously, so the staged planes are complete before the endpoint
serves them; the import's chunk windows scatter on the fetching thread's
current stream. A bf16 pool's planes (uint16 bits in the port's payloads)
are staged as ``bfloat16`` (``bf16_planes``), so the bytes equal the JAX
package's.

Export stages the ``host`` representation (the portable numpy planes
``export_kv_blocks`` already produces) at the source engine's
:class:`~.endpoint.KVEndpoint` and puts only ``(endpoint, transfer_id)``
in the handoff — no payload travels with the descriptor, so the handoff
itself can cross a process boundary as one META frame
(:func:`~.wire.encode_handoff_meta`). Import dials the endpoint and pulls
credit-flow-controlled chunk windows, scattering each through the same
fixed-window donated readmit program the host transport uses — the
scatter for window k dispatches while window k+1 is still on the wire,
so decode starts before the tail lands.

Failure semantics: wire faults (socket errors, checksum/version
rejections, credit stalls) surface as :class:`HandoffError` from the
import, which unwinds the target pool via ``import_sequence`` and rides
the router's bounded transfer-edge retries. The staged payload is
immutable and survives the failed attempt, so the retry re-FETCHes the
same transfer id; only the router's final success/abort releases it.
Injected chaos faults (``net.connect`` / ``net.send`` / ``net.recv``)
propagate raw so the harness can count them.
"""

import os
from typing import List, Optional

import torch

from deepspeed_tpu_torch.serving.cluster.handoff import (
    HandoffError,
    KVHandoff,
    KVTransport,
    _payload_nbytes,
)
from deepspeed_tpu_torch.serving.net import endpoint as net_endpoint
from deepspeed_tpu_torch.serving.net import wire

__all__ = ["RemoteTransport", "ensure_endpoint", "bf16_planes",
           "DEFAULT_CREDIT_WINDOWS"]

# double-buffered by default: one window scattering, one on the wire
DEFAULT_CREDIT_WINDOWS = 2


def ensure_endpoint(engine, host: Optional[str] = None
                    ) -> net_endpoint.KVEndpoint:
    """The engine's lazily created KVEndpoint (one listener per engine,
    port 0 = ephemeral). Created on first remote export so a bare
    ``export_sequence(..., transport="remote")`` works without a Router;
    the Router reads/creates the same attribute for health metadata and
    closes it at shutdown.

    Binding and discovery are separate concerns: ``DSTPU_KV_BIND_HOST``
    (default 127.0.0.1) picks the interface the listener binds, while
    ``DSTPU_KV_ENDPOINT_HOST`` is the ADVERTISED host — the address
    handoff descriptors and /health metadata hand to importers on other
    machines. Unset, the endpoint advertises its bind address (the
    single-host behavior). An endpoint a finished Router closed is
    replaced, so an engine serves behind one Router after another."""
    ep = getattr(engine, "_kv_endpoint", None)
    if ep is None or ep.closed:
        bind = host or os.environ.get("DSTPU_KV_BIND_HOST", "127.0.0.1")
        ep = net_endpoint.KVEndpoint(
            host=bind,
            name=str(getattr(engine, "replica_name", None) or "engine"),
            advertise_host=os.environ.get("DSTPU_KV_ENDPOINT_HOST"),
        ).start()
        engine._kv_endpoint = ep
    return ep


def bf16_planes(engine) -> List[str]:
    """The names of ``engine``'s bfloat16 KV pool planes: the planes its
    host payload carries as uint16 bits and the wire tags ``bfloat16``."""
    pools = getattr(engine, "_kv_pool_planes", None)
    if pools is None:
        return []
    return sorted(name for name, pool in pools().items() if pool.dtype == torch.bfloat16)


class RemoteTransport(KVTransport):
    """``host``-representation planes over a credit-flow-controlled
    socket wire; the only transport whose handoffs survive pickling away
    from the exporting process."""

    name = "remote"

    def __init__(self, credit_windows: int = DEFAULT_CREDIT_WINDOWS,
                 io_timeout_s: float = net_endpoint.DEFAULT_IO_TIMEOUT_S):
        self.credit_windows = int(credit_windows)
        self.io_timeout_s = float(io_timeout_s)

    def export(self, engine, blocks: List[int], handoff: KVHandoff) -> None:
        export = getattr(engine, "export_kv_blocks", None)
        if export is None:
            return  # compute-free fake: bookkeeping-only handoff
        payload = export(blocks)
        kv = getattr(getattr(engine, "config", None), "kv_cache", None)
        chunk = int(getattr(kv, "host_tier_chunk_blocks", 8) or 8)
        ep = ensure_endpoint(engine)
        handoff.transfer_id = ep.stage(handoff.uid, payload, chunk,
                                       bf16=bf16_planes(engine))
        handoff.endpoint = ep.address
        handoff.chunk_blocks = chunk
        handoff.nbytes = _payload_nbytes(payload)
        # the payload never rides the handoff object: a remote descriptor
        # must stay cheap enough to serialize as one META frame
        handoff.payload = None

    def _import_payload(self, engine, handoff: KVHandoff, seq,
                        n_cached: int, fresh: List[int]) -> None:
        if handoff.endpoint is None or not fresh:
            return  # fake-engine handoff (or fully trie-covered import)
        chunked = getattr(engine, "import_kv_blocks_chunked", None)
        plain = getattr(engine, "import_kv_blocks", None)
        if chunked is None and plain is None:
            raise HandoffError(
                f"import({handoff.uid}): target engine has no "
                "import_kv_blocks(_chunked) — remote-transport handoffs "
                "need an engine_v2 pool on the importing side"
            )
        chunk = max(1, int(handoff.chunk_blocks))

        def on_chunk(lo, hi, planes):
            # source columns [lo, hi) map to the fresh tail of the target
            # table; lo >= n_cached because the FETCH starts past the
            # trie/host-tier covered prefix
            dest = fresh[lo - n_cached:hi - n_cached]
            if len(dest) != hi - lo:
                raise wire.WireError(
                    f"CHUNK [{lo}, {hi}) outside the {len(fresh)} fresh "
                    f"blocks past n_cached={n_cached}")
            if chunked is not None:
                # fixed-window donated scatter (async dispatch): the wire
                # recv of the NEXT window overlaps this scatter
                chunked(dest, planes, chunk_blocks=chunk)
            else:
                plain(dest, planes)

        try:
            stats = net_endpoint.fetch_chunks(
                handoff.endpoint,
                handoff.transfer_id,
                start_block=n_cached,
                n_blocks=handoff.n_blocks,
                chunk_blocks=chunk,
                on_chunk=on_chunk,
                credit_windows=self.credit_windows,
                io_timeout_s=self.io_timeout_s,
                replica=getattr(engine, "replica_name", None),
            )
        except (wire.WireError, OSError) as e:
            raise HandoffError(
                f"import({handoff.uid}): remote wire to "
                f"{handoff.endpoint[0]}:{handoff.endpoint[1]} failed: {e}"
            ) from e
        handoff.inflight_windows = int(stats.get("max_inflight_windows", 0))

    def abort(self, engine, handoff: KVHandoff) -> None:
        """Drop the staged transfer of a handoff that will never import
        (request terminated / retries exhausted) so the exporter's stage
        table cannot leak. ``engine`` is the SOURCE engine; a handoff
        staged by another process is released by that process's DONE/
        timeout path instead."""
        ep = getattr(engine, "_kv_endpoint", None)
        if ep is not None and handoff.transfer_id is not None:
            ep.release(handoff.transfer_id)
