"""Content digests shared by checkpoint manifests and the replica audit.

Counterpart of ``zero_transformer_tpu/resilience/detect.py::leaf_checksum``
(:27) and its host twin ``checkpoint.py::_np_checksum`` (:65): the exact
uint32 wrap-sum of a tensor's raw bits. 16-bit dtypes sum as 16-bit words,
32-bit dtypes as 32-bit words, 64-bit dtypes as pairs of 32-bit words, and
bool as uint8, each word zero-extended. Integer addition is exact and
commutative, so the digest of a logical tensor does not depend on how it
was split over ranks: the sum of its pieces' digests, mod 2^32, is its
digest. One flipped bit changes it by 2^k mod 2^32.
"""
from __future__ import annotations

import torch

CHUNK = 1 << 24  # words summed per int64 partial (128 MB of int64 at most)
_WORDS = {1: (torch.uint8, 0xFF), 2: (torch.int16, 0xFFFF), 4: (torch.int32, 0xFFFFFFFF),
          8: (torch.int32, 0xFFFFFFFF)}


def leaf_checksum(x: torch.Tensor) -> int:
    """The uint32 wrap-sum of ``x``'s bits, computed on ``x``'s device in
    chunks of ``CHUNK`` words whose int64 partial sums are taken mod 2^32
    (a chunk's sum stays below 2^56, so no partial overflows)."""
    x = x.detach()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    word, mask = _WORDS[x.element_size()]
    words = x.contiguous().reshape(-1).view(word)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for start in range(0, words.numel(), CHUNK):
        part = words[start:start + CHUNK].to(torch.int64) & mask
        total = (total + part.sum()) & 0xFFFFFFFF
    return int(total)
