from .ops import decode_attention
from .paged import paged_decode_attention
from .ref import (decode_attention_reference, gather_pages, merge_partials,
                  paged_decode_attention_reference,
                  paged_split_decode_attention_reference,
                  split_decode_attention_reference)

__all__ = ["decode_attention", "decode_attention_reference", "gather_pages",
           "merge_partials", "paged_decode_attention",
           "paged_decode_attention_reference",
           "paged_split_decode_attention_reference",
           "split_decode_attention_reference"]
