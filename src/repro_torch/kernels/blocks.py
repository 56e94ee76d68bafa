"""Block geometry shared by the kernels' wrappers (port of the part of
``repro.kernels.blocks`` the port needs: ``divisor_chunk``), and the
flash-attention chunk defaults that K7's plain version, its wrapper and
the chunked ``models.attention.flash_attend`` must share for the backward
to be the vjp of the forward's geometry (``repro.kernels.ops.flash_fwd``
and ``repro.models.attention.flash_attend`` use 512 and 1024)."""
from __future__ import annotations

Q_CHUNK = 512      # query rows per flash-attention chunk
KV_CHUNK = 1024    # key rows per flash-attention chunk


def divisor_chunk(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= ``target`` (>= 1).

    Legalises flash attention's chunk defaults as the JAX package does:
    a 512-row default folds to 256 on a 256-row sequence, and to whatever
    divides an odd length.
    """
    n, target = int(n), max(1, int(target))
    if n <= target:
        return max(1, n)
    for d in range(target, 0, -1):
        if n % d == 0:
            return d
    return 1
