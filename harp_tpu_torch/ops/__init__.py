"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions,
and the long-context attention API.

:mod:`~harp_tpu_torch.ops.ring_attention` is exact blockwise attention over
a sequence-sharded ring (K/V travel by ``rotate``),
:mod:`~harp_tpu_torch.ops.a2a_attention` the Ulysses all-to-all
alternative (regroup to head-sharded, whole-sequence local attention,
regroup back), :mod:`~harp_tpu_torch.ops.rope` the shard-local rotary
embedding, and :mod:`~harp_tpu_torch.ops.moe` expert-parallel MoE over the
same regroup verb.  :mod:`~harp_tpu_torch.ops.flash_attention` is the
single-card kernel K8.
"""

from harp_tpu_torch.ops.a2a_attention import a2a_attention, \
    make_a2a_attention_fn
from harp_tpu_torch.ops.moe import moe_ffn
from harp_tpu_torch.ops.ring_attention import make_ring_attention_fn, \
    ring_attention
from harp_tpu_torch.ops.rope import apply_rope, make_rope_fn

__all__ = ["ring_attention", "make_ring_attention_fn", "a2a_attention",
           "make_a2a_attention_fn", "moe_ffn", "apply_rope", "make_rope_fn"]
