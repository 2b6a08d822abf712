"""Sequence-parallel serving: the ring of sequence shards bert-long runs on.

Counterpart of the JAX package's ``parallel`` for its ``('sp',)`` mesh.
The port is single-controller, as the JAX package is: one process holds a
list of devices, each sequence shard's tensors live on its device, and
the K/V rotation between ring hops is a device-to-device copy.
"""

from .mesh import SeqParallelSet, make_sp_devices  # noqa: F401
from .ring import ring_attention, ring_hop, ring_hop_ref  # noqa: F401
