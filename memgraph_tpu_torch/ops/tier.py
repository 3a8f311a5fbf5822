"""The out-of-core tier's data plane: an edge set as compressed,
host-pinned blocks that stream through the card a sweep at a time.

Port of memgraph_tpu/ops/tier.py.  The edge set is blocked
partition-centrically (ops/csr.py ``ShardedCSR``, by src), but the rows
stay on the host: a fixpoint iteration becomes a sweep that streams one
compressed row at a time through two device buffers
(parallel/streamed.py runs the loop), while the O(n) iterate vectors stay
on the card.

Block wire format (a ShardedCSR row ``p``):

* indices: lossless when ``block`` <= 65536.  ``src`` is local to block
  ``p`` (``src_off`` uint16 + the block base), and the (dst, src) sort
  within the row makes ``dst`` a concatenation of dst-block runs bounded
  by ``block_ptr[p]``, so ``dst_off`` uint16 + the run's block base
  rebuilds it exactly.  8 bytes an edge of int32 indices become 4.
* weights, at the request's precision: ``f32`` verbatim (the sweep stays
  bit-exact), ``bf16`` rounded to nearest even (carried as its 16-bit
  words, ``uint16``: the port has no bfloat16 numpy type), ``int8``
  symmetric per-block quantization (``w ≈ q · scale``, the
  ``semiring.PRECISION_BOUNDS`` budget); accumulation is f32 on the card.

Bytes an edge: 12 raw (int32 + int32 + f32), 8 at f32, 6 at bf16, 5 at
int8.

The admission story (server/kernel_server.py): a request whose resident
footprint exceeds the device budget is not shed outright:
``admission_verdict`` answers **streamed** when the streamed working set
(the iterate vectors and two block buffers) still fits.  ops/delta.py
splices committed deltas into the host rows and ``TierCSR.apply_delta``
re-encodes only the touched rows.

``block_bytes`` (the per-buffer budget) is a parameter; the reference's
``MEMGRAPH_TPU_TIER_BLOCK_BYTES`` knob is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.metrics import global_metrics
from .csr import ShardedCSR, shard_edges

#: device byte budget for ONE streamed block buffer (two are live at once)
DEFAULT_BLOCK_BYTES = 32 << 20

#: O(n) f32 iteration-state vectors the streamed fixpoints keep on the
#: card (iterate, accumulator, inv_wsum, masks and headroom)
VECTOR_SLOTS = 8

#: largest vertex block the uint16 offset codec can address
U16_MAX_BLOCK = 1 << 16

#: wire bytes an edge WEIGHT costs at each precision
_W_BYTES = {"f32": 4, "bf16": 2, "int8": 1}


def edge_wire_bytes(precision: str, u16: bool = True) -> int:
    """Wire bytes one edge costs in a streamed block."""
    idx = 4 if u16 else 8
    return idx + _W_BYTES[precision]


# --------------------------------------------------------------------------
# block codec
# --------------------------------------------------------------------------


def bf16_bits(w: np.ndarray) -> np.ndarray:
    """float32 weights rounded to bfloat16 (nearest even), as uint16 words
    (ml_dtypes' bfloat16 bits)."""
    t = torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


@dataclass(frozen=True)
class HostBlock:
    """One compressed edge block (one ShardedCSR row).

    ``payload`` is the reference's wire dict (name -> numpy array; bf16
    weights as uint16 words), shipped to the card as it is; the decode
    runs there, so the wire bytes are what crosses host to device."""

    payload: dict          # name -> np.ndarray
    nbytes: int            # compressed wire bytes
    raw_nbytes: int        # int32 + f32 equivalent bytes


def _dst_runs(bounds: np.ndarray, per: int) -> np.ndarray:
    """Each edge's dst block from the row's block_ptr boundaries (the
    host half of the codec; the card's decode runs the same search)."""
    return np.searchsorted(bounds[1:], np.arange(per), side="right")


def pack_block(scsr: ShardedCSR, p: int, precision: str) -> HostBlock:
    """Encode ShardedCSR row ``p`` into its streamed wire format."""
    src = np.asarray(scsr.src[p])
    dst = np.asarray(scsr.dst[p])
    w = np.asarray(scsr.weights[p])
    raw = src.nbytes + dst.nbytes + w.nbytes
    u16 = scsr.block <= U16_MAX_BLOCK
    # real edges sort before the padding tail (padding dst = the sink row
    # n_nodes >= every real dst); rc masks the weightless reductions
    rc = int(np.searchsorted(dst, scsr.n_nodes, side="left"))
    payload: dict = {"rc": np.int32(rc)}
    if u16:
        bounds = scsr.block_ptr[p].astype(np.int32)
        q = _dst_runs(bounds, scsr.per)
        payload["src_off"] = (src - np.int32(p * scsr.block)
                              ).astype(np.uint16)
        payload["dst_off"] = (dst - (q * scsr.block)).astype(np.uint16)
        payload["bounds"] = bounds
        payload["base"] = np.int32(p * scsr.block)
    else:
        payload["src"] = src
        payload["dst"] = dst
    if precision == "f32":
        payload["w"] = w
    elif precision == "bf16":
        payload["w"] = bf16_bits(w)
    elif precision == "int8":
        amax = float(np.max(np.abs(w))) if w.size else 0.0
        scale = np.float32(max(amax / 127.0, 1e-30))
        payload["w"] = np.clip(np.round(w / scale), -127, 127
                               ).astype(np.int8)
        payload["scale"] = scale
    else:
        raise ValueError(f"tier precision must be f32/bf16/int8, "
                         f"got {precision!r}")
    nbytes = sum(int(np.asarray(v).nbytes) for v in payload.values())
    return HostBlock(payload=payload, nbytes=nbytes, raw_nbytes=raw)


# --------------------------------------------------------------------------
# the paging plan
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class TierCSR:
    """Host paging plan: a ShardedCSR whose rows never all go to the card
    at once, and their encoded wire blocks."""

    scsr: ShardedCSR       # HOST layout: the delta-splice substrate
    blocks: tuple          # HostBlock a row
    precision: str

    @property
    def n_blocks(self) -> int:
        return self.scsr.n_shards

    @property
    def block(self) -> int:
        return self.scsr.block

    @property
    def per(self) -> int:
        return self.scsr.per

    @property
    def n_nodes(self) -> int:
        return self.scsr.n_nodes

    @property
    def n_edges(self) -> int:
        return self.scsr.n_edges

    @property
    def n_pad2(self) -> int:
        return self.scsr.n_pad2

    @property
    def u16(self) -> bool:
        return self.scsr.block <= U16_MAX_BLOCK

    @property
    def wire_bytes_per_sweep(self) -> int:
        """Bytes one sweep over the edge set ships."""
        return sum(b.nbytes for b in self.blocks)

    @property
    def raw_bytes_per_sweep(self) -> int:
        """int32 + f32 equivalent bytes the sweep stands for."""
        return sum(b.raw_nbytes for b in self.blocks)

    def apply_delta(self, delta) -> "TierCSR | None":
        """The plan advanced by one EdgeDelta without a cold re-encode:
        the splice (ops/delta.py ``apply_edge_delta``) rewrites only the
        rows the delta touches, and only those rows are re-packed
        (``tier.blocks_repacked_total``); every other block is the same
        object (``tier.blocks_reused_total``).  None when the splice
        cannot keep the layout (a row overflows, a removal matches no
        edge): the caller rebuilds by ``plan_tier``."""
        from .delta import apply_edge_delta
        new_scsr = apply_edge_delta(self.scsr, delta)
        if new_scsr is None:
            return None
        if new_scsr is self.scsr:      # empty delta
            return self
        block = self.scsr.block
        key_add = delta.add_src if self.scsr.by == "src" else delta.add_dst
        key_rem = delta.rem_src if self.scsr.by == "src" else delta.rem_dst
        touched = np.union1d(np.unique(key_add // block),
                             np.unique(key_rem // block)).astype(np.int64)
        blocks = list(self.blocks)
        for p in touched:
            blocks[int(p)] = pack_block(new_scsr, int(p), self.precision)
        global_metrics.increment("tier.blocks_repacked_total",
                                 len(touched))
        global_metrics.increment("tier.blocks_reused_total",
                                 len(blocks) - len(touched))
        return TierCSR(scsr=new_scsr, blocks=tuple(blocks),
                       precision=self.precision)


def tier_from_scsr(scsr: ShardedCSR, precision: str = "f32") -> TierCSR:
    """Pack a host ShardedCSR into a paging plan (no re-sort, no
    re-blocking)."""
    if not isinstance(scsr.src, np.ndarray):
        raise ValueError("tier_from_scsr needs the HOST-side layout")
    blocks = tuple(pack_block(scsr, p, precision)
                   for p in range(scsr.n_shards))
    return TierCSR(scsr=scsr, blocks=blocks, precision=precision)


def plan_blocks(n_nodes: int, n_edges: int, precision: str = "f32",
                block_bytes: int | None = None) -> int:
    """The block count P: enough that one row's wire payload fits the
    per-buffer budget, that vertex blocks stay uint16-addressable, and at
    least 2, so the two buffers alternate."""
    bb = block_bytes or DEFAULT_BLOCK_BYTES
    wire = max(n_edges, 1) * edge_wire_bytes(precision, u16=True)
    p_budget = -(-wire // bb)
    # margin for shard_edges' block_multiple rounding
    p_u16 = -(-(n_nodes + 1) // (U16_MAX_BLOCK - 8))
    return max(2, int(p_budget), int(p_u16))


def plan_tier(src, dst, weights, n_nodes: int, *,
              precision: str = "f32", n_blocks: int | None = None,
              block_bytes: int | None = None,
              slack: float = 0.0) -> TierCSR:
    """Block a COO edge set into a host paging plan.  ``slack`` (port
    only, ops/csr.py ``shard_edges``): the rows' room for added edges."""
    if n_blocks is None:
        n_blocks = plan_blocks(n_nodes, len(np.asarray(src)), precision,
                               block_bytes)
    scsr = shard_edges(src, dst, weights, n_nodes, int(n_blocks), by="src",
                       slack=slack)
    return tier_from_scsr(scsr, precision)


# --------------------------------------------------------------------------
# admission estimates (the kernel server's third verdict)
# --------------------------------------------------------------------------

#: device bytes ONE streamed edge costs at a sweep's peak beside its wire
#: bytes: the decoded int32 src and dst and their int32 temporaries, the
#: f32 weight, and PageRank's product with 1/wsum[src] (katz folds the
#: weight as it is; WCC decodes no weight, but gathers an int32 label an
#: edge and widens its keys to int64).  The reference prices {pagerank:
#: 36, katz: 36, wcc: 16}; refitted on the port's peaks
#: (``torch.cuda.max_memory_allocated`` over a streamed run at the north
#: star's 16 blocks of 637k edges, chip_smoke.py's ``tier`` phase,
#: NVIDIA H100 80GB HBM3, 700.00 W: PageRank f32 58.2 MB, int8 55.2 MB,
#: katz 47.7 MB, WCC 37.6 MB, where the reference's table gives 1.02x,
#: 1.04x, 1.25x and 1.25x), these put the estimate 1.11-1.25x above the
#: peak.  The phase holds it within [1x, 2x].
DECODED_EDGE_BYTES = {"pagerank": 44, "katz": 28, "wcc": 16}


def _ceil8(n: int) -> int:
    """shard_edges' block_multiple=8 rounding, mirrored for pricing."""
    return -(-int(n) // 8) * 8


def streamed_request_bytes(n_nodes: int, n_edges: int,
                           precision: str = "f32",
                           block_bytes: int | None = None,
                           algorithm: str = "pagerank") -> int:
    """The working set of a STREAMED run: the O(n) vectors on the card
    (over the plan's padded node count), one block at its decoded sweep
    peak and the next block's wire payload in flight.  Priced for the
    plan ``plan_blocks`` would build; shard skew can push a real plan's
    rows past the even split priced here."""
    bb = block_bytes or DEFAULT_BLOCK_BYTES
    p = plan_blocks(n_nodes, n_edges, precision, bb)
    block = _ceil8(-(-(n_nodes + 1) // p))
    n_pad2 = p * block
    e_blk = _ceil8(-(-max(n_edges, 1) // p))
    vectors = n_pad2 * 4 * VECTOR_SLOTS
    decoded = e_blk * DECODED_EDGE_BYTES.get(str(algorithm),
                                             DECODED_EDGE_BYTES["pagerank"])
    wire_in_flight = e_blk * edge_wire_bytes(precision, u16=True)
    return vectors + decoded + wire_in_flight


def admission_verdict(est_resident: int, budget: int, *, n_nodes: int,
                      n_edges: int, streamable: bool = True,
                      precision: str = "f32",
                      algorithm: str = "pagerank",
                      block_bytes: int | None = None) -> tuple[str, int]:
    """(verdict, bytes of the chosen mode): resident when the resident
    estimate fits the budget, streamed when a streamable request's
    working set fits it, else shed."""
    if est_resident <= budget:
        return "resident", int(est_resident)
    est_streamed = streamed_request_bytes(n_nodes, n_edges, precision,
                                          block_bytes, algorithm=algorithm)
    if streamable and est_streamed <= budget:
        return "streamed", int(est_streamed)
    return "shed", int(est_streamed)
