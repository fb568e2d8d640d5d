"""The serving stack of the port (mirrors ``deepspeed_tpu/serving``).

Only ``resilience.faults`` is ported so far: the engine's host-tier
readmit checks its fault site. The serving loop, router, HTTP server,
speculative proposers and the rest are ROADMAP queue 1, item 5.
"""
