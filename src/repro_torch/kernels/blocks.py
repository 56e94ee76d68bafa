"""Block geometry shared by the kernels' wrappers and the tuner (port of
``repro.kernels.blocks``).

The fit math of the JAX package's VMEM-tiled kernels (``pad_to``,
``lane_pad``, ``clamp_block_v``, ``grid_v``, ``solver_tile_bytes``,
``fits_vmem``) is kept as the JAX package has it, so that the tuner's
analytic tier reasons about the same tiles; the port's own kernels are
bounded by a block's shared memory on Hopper instead (``fits_smem``).
Also the flash-attention chunk defaults that K7's plain version, its
wrapper and the chunked ``models.attention.flash_attend`` must share for
the backward to be the vjp of the forward's geometry
(``repro.kernels.ops.flash_fwd`` and ``repro.models.attention.
flash_attend`` use 512 and 1024).
"""
from __future__ import annotations

LANE = 128          # TPU lane width: last-dim tiles are multiples of this
DEFAULT_BLOCK_V = 2048   # the JAX kernels' vocab tile
VMEM_BYTES = 16 * 1024 * 1024   # per-core VMEM of the JAX package's TPU
SMEM_BYTES = 227 * 1024         # shared memory one Hopper block may use

Q_CHUNK = 512      # query rows per flash-attention chunk
KV_CHUNK = 1024    # key rows per flash-attention chunk


def pad_to(n: int, mult: int) -> int:
    """Smallest multiple of ``mult`` >= ``n`` (n >= 0, mult >= 1)."""
    return -(-int(n) // int(mult)) * int(mult)


def lane_pad(n: int) -> int:
    """Pad a candidate-axis length to the TPU lane width."""
    return pad_to(max(int(n), 1), LANE)


def clamp_block_v(block: int | None, v: int, *, lane: int = LANE) -> int:
    """Legalise a requested vocab block for a length-``v`` axis: round up
    to a lane multiple and cap at the lane-padded axis; ``None`` is
    :data:`DEFAULT_BLOCK_V`."""
    if block is None:
        block = DEFAULT_BLOCK_V
    b = pad_to(max(int(block), 1), lane)
    return min(b, pad_to(max(int(v), 1), lane))


def grid_v(v: int, block: int) -> tuple[int, int]:
    """(padded axis length, grid steps) for a legalised block."""
    v_pad = pad_to(max(int(v), 1), block)
    return v_pad, v_pad // block


def solver_tile_bytes(block_v: int, m: int, *, itemsize: int = 4,
                      acc_rows: int = 1) -> int:
    """Working set of one JAX solver-kernel grid step: the streamed
    (1, block_v) tile, the lane-padded candidate row, the (1, acc_rows,
    m_pad) accumulator and the broadcast (1, m_pad, block_v) compare."""
    m_pad = lane_pad(m)
    return itemsize * (block_v + m_pad * (1 + acc_rows) + m_pad * block_v)


def fits_vmem(tile_bytes: int, *, budget: int | None = None,
              fraction: float = 0.5) -> bool:
    """True if a grid step's working set fits the VMEM budget fraction."""
    cap = (VMEM_BYTES if budget is None else budget) * fraction
    return tile_bytes <= cap


def fits_smem(block_bytes: int, *, budget: int = SMEM_BYTES) -> bool:
    """True if one Hopper block's dynamic shared memory fits the card's
    227 KB a block: the legality test of the kernel tier's geometries."""
    return 0 <= block_bytes <= budget


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
