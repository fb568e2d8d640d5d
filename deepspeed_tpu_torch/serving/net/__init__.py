"""Cross-process KV + control wire for disaggregated serving
(mirrors ``deepspeed_tpu/serving/net``; torch, numpy and the stdlib only,
byte-compatible with the JAX package's wire).

Layers, bottom up: :mod:`.wire` (versioned checksummed binary frames),
:mod:`.flow` (block-granular credit window), :mod:`.endpoint`
(per-engine listener + chunk-fetch client), :mod:`.transport`
(``RemoteTransport``, registered as ``--kv-transport remote``), and
:mod:`.control` (the multi-host control plane's RPC/events channels —
SUBMIT/TOKEN/CANCEL/HEALTH/ADOPT/STATS/EVENT/GOODBYE frames on the same
wire format).
"""

from deepspeed_tpu_torch.serving.net.wire import (  # noqa: F401
    PROTOCOL_VERSION,
    WireError,
    decode_handoff_meta,
    encode_handoff_meta,
)
from deepspeed_tpu_torch.serving.net.flow import CreditWindow, CreditError  # noqa: F401
from deepspeed_tpu_torch.serving.net.endpoint import KVEndpoint, fetch_chunks  # noqa: F401
from deepspeed_tpu_torch.serving.net.control import (  # noqa: F401
    ControlChannel,
    ControlEndpoint,
    ControlRefused,
    dial_control,
)

__all__ = [
    "PROTOCOL_VERSION",
    "WireError",
    "encode_handoff_meta",
    "decode_handoff_meta",
    "CreditWindow",
    "CreditError",
    "KVEndpoint",
    "fetch_chunks",
    "ControlChannel",
    "ControlEndpoint",
    "ControlRefused",
    "dial_control",
]
