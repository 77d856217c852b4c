from repro_torch.kernels.paged_attention.ops import (
    paged_attention,
    paged_prefill_attention,
)
from repro_torch.kernels.paged_attention.ref import (
    gather_pages,
    paged_attention_reference,
    paged_prefill_attention_reference,
)

__all__ = [
    "gather_pages", "paged_attention", "paged_attention_reference",
    "paged_prefill_attention", "paged_prefill_attention_reference",
]
