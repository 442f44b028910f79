"""PyTorch/CUDA port of the GossipSub simulator.

The JAX package ``go_libp2p_pubsub_tpu`` is the reference this package is
held against; the two share no code.  Module names follow the reference so
each counterpart is easy to find:

- ``ops/graph.py``        packed-word primitives and the lane-hash RNG
- ``ops/kernels/``        the hand-written Hopper kernels (``csrc/``) and
                          their plain PyTorch versions
- ``models/gossipsub.py`` the scored GossipSub v1.1 heartbeat
- ``models/_delivery.py`` first-delivery bookkeeping
- ``models/plan.py``      named refusals for options outside the port
- ``convert.py``          carrying params/state across from the reference

Packed u32 words are ``torch.int32`` tensors holding the u32 bit patterns
(torch's CPU ``uint32`` has no shifts).  Every entry point takes an
explicit ``device``; the default is ``cuda`` and there is no fallback.
"""

from .device import DEFAULT_DEVICE, resolve_device  # noqa: F401
