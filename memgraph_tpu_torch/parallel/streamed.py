"""The streamed execution plane: PageRank, katz and WCC over an edge set
that never sits on the card whole.

Port of the tier half of memgraph_tpu/parallel/distributed.py.  The data
plane (ops/tier.py) keeps the blocked edge rows on the host as compressed
wire blocks; this is the loop that runs a fixpoint over them, with the
O(n) iterate, accumulator and environment vectors on the card:

    per iteration (one sweep over the P blocks):
      copy block 0 to buffer 0                     (copy stream)
      for k in 0..P-1:
        copy block k+1 to buffer (k+1) % 2         (copy stream)
        acc = fold(acc, decode(buffer k % 2))      (compute stream)
      x, metric = epilogue(x, acc)

The blocks' host tensors are pinned once (``pin_memory``, kept on the
HostBlock, so a plan that a commit re-packs keeps its other blocks'
pinned copies), and a copy is ``non_blocking``: block k+1 crosses while
block k folds.  Events order the two streams: a fold waits for its
block's copy, and a copy into a buffer waits for the fold that last read
it (two static buffers a run).  The first streamed iteration runs the
schedule serially (copy, wait, fold, wait, a block at a time) to price
transfer and compute apart; each later iteration's wall clock gives
``tier.transfer_hidden_fraction`` = (T_xfer + T_comp - T_iter) / T_xfer,
the share of the transfer the overlap hid.  On the CPU the "transfer" is
the host tensor itself.

Every float sum is deterministic: a fold sums its block with K1
(ops/segment_cuda.py ``csr_spmm_sum``) over the block's dst runs (dst is
sorted within a row); PageRank's weight sums over src (unsorted within a
row) run K1 over a stable sort, never through float atomics; the dangling
mass and PageRank's L1 error are K2 (``lane_sum``).  WCC's min uses
``scatter_reduce_`` (exact in any order), its padding edges masked by the
block's real-edge count ``rc``.

The resident comparator (``resident=True``) places every block once and
runs the identical kernels in the identical order: only the transfer
schedule differs, so streamed and resident answers are bit-equal at f32,
bf16 and int8.

Runs go through parallel/checkpoint.py ``run_resumable``: chunks of
``checkpoint_every`` iterations, a device fault resumed bit-exact from
the last chunk, a ``device_lost`` dropping the environment, the resident
blocks and the buffers so that they are placed again.  Entry points run
on ``cuda`` unless ``device=`` asks for the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import segment_cuda as SC
from ..ops import tier as mgtier
from ..observability import stats as mgstats
from ..ops.semiring import pagerank_update
from ..utils.metrics import global_metrics
from .checkpoint import run_resumable


# --------------------------------------------------------------------------
# host tensors and their decode
# --------------------------------------------------------------------------

#: payload entries that are host scalars (kernel arguments, not copies)
_SCALARS = ("rc", "base")


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    """A payload array as a torch tensor of the same bytes (uint16 words
    through an int16 view: torch's CUDA kernels lack uint16)."""
    a = np.ascontiguousarray(np.atleast_1d(a))
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a)


def _host_tensors(tier, p: int, pin: bool) -> dict:
    """Block ``p``'s host tensors (pinned once when ``pin``), with its
    scalars and its longest runs (of dst, and of src within the block),
    which shape K1's launch, counted on the host once."""
    hb = tier.blocks[p]
    got = getattr(hb, "_host", None)
    if got is not None and (got["pinned"] or not pin):
        return got
    tensors = {k: _as_tensor(v) for k, v in hb.payload.items()
               if k not in _SCALARS}
    if pin:
        tensors = {k: t.pin_memory() for k, t in tensors.items()}
    scsr = tier.scsr
    rc = int(hb.payload["rc"])
    dst = scsr.dst[p]
    cuts = np.flatnonzero(np.diff(dst[:rc])) + 1
    runs = np.diff(np.concatenate([[0], cuts, [rc]])) if rc else [0]
    base = p * scsr.block
    got = {"tensors": tensors, "pinned": pin, "rc": rc, "base": base,
           "dst_longest": max(int(np.max(runs)), scsr.per - rc),
           "src_longest": int(np.bincount(
               scsr.src[p].astype(np.int64) - base,
               minlength=1).max())}
    object.__setattr__(hb, "_host", got)     # HostBlock is frozen
    return got


class _Decoder:
    """A run's device constants for the decode: ``arange(per)`` (the dst
    run search and WCC's real-edge mask)."""

    def __init__(self, tier, device: torch.device) -> None:
        self.block = tier.block
        self.precision = tier.precision
        self.u16 = tier.u16
        self.iota = torch.arange(tier.per, dtype=torch.int32, device=device)

    def src(self, t: dict, meta: dict):
        """A block's src, int32, on the card."""
        if not self.u16:
            return t["src"]
        return (t["src_off"].to(torch.int32) & 0xFFFF) + meta["base"]

    def indices(self, t: dict, meta: dict):
        """(src, dst) int32 of a block's tensors on the card."""
        if not self.u16:
            return t["src"], t["dst"]
        src = self.src(t, meta)
        q = torch.searchsorted(t["bounds"][1:], self.iota, right=True,
                               out_int32=True)
        dst = (t["dst_off"].to(torch.int32) & 0xFFFF) + q * self.block
        return src, dst

    def weights(self, t: dict):
        w = t["w"]
        if self.precision == "bf16":
            return w.view(torch.bfloat16).to(torch.float32)
        if self.precision == "int8":
            return w.to(torch.float32) * t["scale"]
        return w


# --------------------------------------------------------------------------
# the sweep
# --------------------------------------------------------------------------


class _Stream:
    """The double-buffered transfer of one run: two static buffers on the
    card, a copy stream and the events that order it with the compute
    stream.  On the CPU the host tensors serve as they are."""

    def __init__(self, tier, device: torch.device, pin: bool) -> None:
        self.tier = tier
        self.device = device
        self.cuda = device.type == "cuda"
        self.pin = pin and self.cuda
        self.buffers = [None, None]
        self.freed = [None, None]
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)
            self.copied = [torch.cuda.Event(), torch.cuda.Event()]

    def meta(self, p: int) -> dict:
        return _host_tensors(self.tier, p, self.pin)

    def put(self, p: int, slot: int) -> dict:
        """Start block ``p``'s copy into buffer ``slot``; its tensors."""
        host = self.meta(p)["tensors"]
        if not self.cuda:
            return host
        if self.buffers[slot] is None:
            self.buffers[slot] = {k: torch.empty_like(t, device=self.device)
                                  for k, t in host.items()}
        buf = self.buffers[slot]
        with torch.cuda.stream(self.copy_stream):
            if self.freed[slot] is not None:
                self.copy_stream.wait_event(self.freed[slot])
            for k, t in host.items():
                buf[k].copy_(t, non_blocking=True)
            self.copied[slot].record(self.copy_stream)
        return buf

    def ready(self, slot: int) -> None:
        """Make the compute stream wait for buffer ``slot``'s copy."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self.copied[slot])

    def release(self, slot: int) -> None:
        """Mark buffer ``slot`` free once the folds queued so far ran."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.freed[slot] = ev

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)


def _place_blocks(tier, device: torch.device) -> list:
    """Every block's tensors on the card (the resident comparator)."""
    out = []
    for p in range(tier.n_blocks):
        host = _host_tensors(tier, p, False)["tensors"]
        out.append({k: t.to(device) for k, t in host.items()})
    return out


def _tier_sweep(tier, stream: _Stream, dev_blocks, fold, acc,
                measure=None):
    """One pass over the blocks: ``acc = fold(acc, tensors, meta)``.

    ``dev_blocks`` set: the resident comparator (placed blocks, the same
    folds in the same order).  ``measure`` set: the serial timed
    schedule.  Otherwise the double-buffered stream."""
    n = tier.n_blocks
    if dev_blocks is not None:
        for p in range(n):
            acc = fold(acc, dev_blocks[p], stream.meta(p))
        return acc
    if measure is not None:
        for p in range(n):
            t0 = time.perf_counter()
            blk = stream.put(p, 0)
            stream.ready(0)
            stream.sync()
            t1 = time.perf_counter()
            acc = fold(acc, blk, stream.meta(p))
            stream.release(0)
            stream.sync()
            t2 = time.perf_counter()
            measure["t_xfer"] += t1 - t0
            measure["t_comp"] += t2 - t1
            global_metrics.observe("tier.block_transfer_latency_sec",
                                   t1 - t0)
        return acc
    bufs = [stream.put(0, 0), None]
    for p in range(n):
        slot = p % 2
        if p + 1 < n:
            bufs[1 - slot] = stream.put(p + 1, 1 - slot)
        stream.ready(slot)
        acc = fold(acc, bufs[slot], stream.meta(p))
        stream.release(slot)
    return acc


def _count_sweep(tier) -> None:
    global_metrics.increment("tier.blocks_streamed_total", tier.n_blocks)
    global_metrics.increment("tier.bytes_streamed_total",
                             tier.raw_bytes_per_sweep)
    global_metrics.increment("tier.compressed_bytes_total",
                             tier.wire_bytes_per_sweep)


def _warm_vertex_vector(x0, n_pad2: int, n_nodes: int, dtype,
                        pad_value=None) -> np.ndarray:
    """A warm start (n_nodes,) padded to the plan's n_pad2 vertices:
    ``pad_value`` None fills padding rows with their own index (the label
    convention), a scalar fills directly."""
    if pad_value is None:
        v = np.arange(n_pad2, dtype=dtype)
    else:
        v = np.full(n_pad2, pad_value, dtype=dtype)
    x0 = np.asarray(x0)
    n = min(len(x0), n_nodes)
    v[:n] = x0[:n].astype(dtype, copy=False)
    return v


def _tier_fixpoint(*, algo, tier, device, env_of, iterate, x0, metric0,
                   keep_going, max_iterations, resident=False,
                   stats=None, checkpoint_every=0, job=None, store=None,
                   retry=None, chunk_deadline_s=None, report=None):
    """The streamed fixpoint driver, on the checkpoint layer.

    ``env_of(sweep)`` builds the run's environment on the card (it may
    sweep the blocks itself: PageRank's weight sums); ``iterate(x, env,
    sweep)`` runs ONE iteration (a sweep and the epilogue) and returns
    ``(new_x, metric)``, the metric a 0-d tensor."""
    global_metrics.set_gauge(
        "tier.modeled_request_bytes",
        float(mgtier.streamed_request_bytes(
            tier.n_nodes, tier.n_edges, tier.precision, algorithm=algo)))
    holder: dict = {}
    measured = {"serial": None, "iters": 0, "hidden_sum": 0.0,
                "overlap_iters": 0, "overlap_wall": 0.0}

    def run_state():
        st = holder.get("state")
        if st is None:
            stream = _Stream(tier, device, pin=not resident)
            for p in range(tier.n_blocks):      # pinned before any timing
                stream.meta(p)
            st = holder["state"] = {
                "stream": stream,
                "blocks": _place_blocks(tier, device) if resident else None}
        return st

    def sweep(fold, acc, measure=None):
        st = run_state()
        out = _tier_sweep(tier, st["stream"], st["blocks"], fold, acc,
                          measure=measure)
        if not resident:
            _count_sweep(tier)
        return out

    def env():
        e = holder.get("env")
        if e is None:
            e = holder["env"] = env_of(lambda f, a: sweep(f, a))
        return e

    def chunk(carry, it_stop):
        x, metric, it = carry
        x = torch.as_tensor(x, device=device)
        while it < it_stop and keep_going(metric):
            measure = None
            if not resident and measured["serial"] is None:
                measure = {"t_xfer": 0.0, "t_comp": 0.0}
            e = env()
            t0 = time.perf_counter()
            x, m_dev = iterate(x, e, lambda f, a: sweep(f, a, measure))
            metric = m_dev.item()
            wall = time.perf_counter() - t0
            if measure is not None:
                measured["serial"] = measure
                mgstats.record_stage("device_transfer", measure["t_xfer"])
            elif not resident and measured["serial"] is not None:
                s = measured["serial"]
                if s["t_xfer"] > 0:
                    hidden = (s["t_xfer"] + s["t_comp"] - wall) \
                        / s["t_xfer"]
                    hidden = min(max(hidden, 0.0), 1.0)
                    measured["hidden_sum"] += hidden
                    measured["overlap_iters"] += 1
                    measured["overlap_wall"] += wall
                    global_metrics.observe(
                        "tier.transfer_hidden_fraction", hidden)
            measured["iters"] += 1
            it += 1
        return x, metric, it

    def rebuild():
        holder.clear()                        # re-place env, blocks, buffers
        return None

    x, metric, iters = run_resumable(
        algo=algo, chunk=chunk, carry=(x0, metric0, 0),
        carry_to_host=lambda c: (np.array(torch.as_tensor(c[0]).cpu()),
                                 c[1], int(c[2])),
        carry_from_host=lambda p: p, iter_of=lambda c: int(c[2]),
        max_iterations=max_iterations,
        checkpoint_every=checkpoint_every, job=job, store=store,
        retry=retry, rebuild=rebuild, chunk_deadline_s=chunk_deadline_s,
        report=report)

    if stats is not None:
        s = measured["serial"] or {"t_xfer": 0.0, "t_comp": 0.0}
        n_ov = measured["overlap_iters"]
        stats.update({
            "mode": "resident" if resident else "streamed",
            "precision": tier.precision,
            "n_blocks": tier.n_blocks,
            "iterations": int(iters),
            "wire_bytes_per_sweep": tier.wire_bytes_per_sweep,
            "raw_bytes_per_sweep": tier.raw_bytes_per_sweep,
            "serial_transfer_s": s["t_xfer"],
            "serial_compute_s": s["t_comp"],
            "overlap_iters": n_ov,
            "overlap_iter_s_mean": (measured["overlap_wall"] / n_ov)
            if n_ov else None,
            "transfer_hidden_fraction": (measured["hidden_sum"] / n_ov)
            if n_ov else None,
        })
    return torch.as_tensor(x).cpu().numpy(), metric, int(iters)


def _valid(tier, device) -> torch.Tensor:
    valid = torch.zeros(tier.n_pad2, dtype=torch.float32, device=device)
    valid[:tier.n_nodes] = 1.0
    return valid


def _x0(x0, tier, default: np.ndarray, pad_value=0.0, dtype=np.float32):
    if x0 is None:
        return default
    return _warm_vertex_vector(x0, tier.n_pad2, tier.n_nodes, dtype,
                               pad_value)


# --------------------------------------------------------------------------
# the fixpoints
# --------------------------------------------------------------------------


def pagerank_streamed(tier, damping: float = 0.85,
                      max_iterations: int = 100, tol: float = 1e-6, *,
                      x0=None, resident: bool = False, stats=None,
                      checkpoint_every: int = 0, job: str | None = None,
                      store=None, retry=None, chunk_deadline_s=None,
                      report=None, device=None):
    """PageRank over a host :class:`~..ops.tier.TierCSR`: only the edge
    blocks stream, the rank vector stays on the card.  Returns
    ``(ranks[:n], err, iters)``."""
    dev = resolve_device(device)
    dec = _Decoder(tier, dev)
    n, n_pad2, block = tier.n_nodes, tier.n_pad2, tier.block
    rnd = "bf16" if tier.precision == "bf16" else "f32"
    n_f = torch.tensor(np.float32(n), device=dev)
    d_f = torch.tensor(np.float32(damping), device=dev)
    x0v = np.zeros(n_pad2, np.float32)
    x0v[:n] = 1.0 / n
    x0v = _x0(x0, tier, x0v)

    def wsum_fold(acc, t, meta):
        local = dec.src(t, meta) - meta["base"]
        w = dec.weights(t)
        order = torch.sort(local, stable=True).indices
        ptr = SC.segment_runs(local[order], block)
        y = SC.csr_spmm_sum(w[order], ptr, mul="first",
                            longest=meta["src_longest"])
        lo = meta["base"]
        acc[lo:lo + block] = acc[lo:lo + block] + y
        return acc

    def env_of(sweep):
        valid_f = _valid(tier, dev)
        wsum = sweep(wsum_fold, torch.zeros(n_pad2, dtype=torch.float32,
                                            device=dev))
        return {"valid_f": valid_f,
                "dangling_f": valid_f * (wsum == 0.0),
                "inv_wsum": torch.where(wsum > 0.0, 1.0 / wsum, 0.0)}

    def iterate(x, env, sweep):
        def fold(acc, t, meta):
            src, dst = dec.indices(t, meta)
            wn = dec.weights(t) * env["inv_wsum"][src]
            ptr = SC.segment_runs(dst, n_pad2)
            return acc + SC.csr_spmm_sum(x, ptr, src, wn, mul="times",
                                         precision=rnd,
                                         longest=meta["dst_longest"])

        acc = sweep(fold, torch.zeros(n_pad2, dtype=torch.float32,
                                      device=dev))
        dm = SC.lane_sum(x, m=env["dangling_f"])
        new = pagerank_update(acc, dm, env["valid_f"], n_f, d_f)
        return new, SC.lane_sum(new, x)

    x, err, iters = _tier_fixpoint(
        algo="pagerank", tier=tier, device=dev, env_of=env_of,
        iterate=iterate, x0=x0v, metric0=float("inf"),
        keep_going=lambda m: m > tol, max_iterations=max_iterations,
        resident=resident, stats=stats, checkpoint_every=checkpoint_every,
        job=job, store=store, retry=retry,
        chunk_deadline_s=chunk_deadline_s, report=report)
    return x[:n], float(err), iters


def katz_streamed(tier, alpha: float = 0.1, beta: float = 1.0,
                  max_iterations: int = 100, tol: float = 1e-6, *,
                  normalized: bool = True, x0=None,
                  resident: bool = False, stats=None,
                  checkpoint_every: int = 0, job: str | None = None,
                  store=None, retry=None, chunk_deadline_s=None,
                  report=None, device=None):
    """Katz centrality over a host TierCSR.  Returns
    ``(scores[:n], err, iters)``."""
    dev = resolve_device(device)
    dec = _Decoder(tier, dev)
    n, n_pad2 = tier.n_nodes, tier.n_pad2
    rnd = "bf16" if tier.precision == "bf16" else "f32"
    a_f = torch.tensor(np.float32(alpha), device=dev)
    b_f = torch.tensor(np.float32(beta), device=dev)
    x0v = _x0(x0, tier, np.zeros(n_pad2, np.float32))

    def env_of(sweep):
        return {"valid_f": _valid(tier, dev)}

    def iterate(x, env, sweep):
        def fold(acc, t, meta):
            src, dst = dec.indices(t, meta)
            ptr = SC.segment_runs(dst, n_pad2)
            return acc + SC.csr_spmm_sum(x, ptr, src, dec.weights(t),
                                         mul="times", precision=rnd,
                                         longest=meta["dst_longest"])

        acc = sweep(fold, torch.zeros(n_pad2, dtype=torch.float32,
                                      device=dev))
        new = env["valid_f"] * (a_f * acc + b_f)
        return new, (new - x).abs().max()

    x, err, iters = _tier_fixpoint(
        algo="katz", tier=tier, device=dev, env_of=env_of,
        iterate=iterate, x0=x0v, metric0=float("inf"),
        keep_going=lambda m: m > tol, max_iterations=max_iterations,
        resident=resident, stats=stats, checkpoint_every=checkpoint_every,
        job=job, store=store, retry=retry,
        chunk_deadline_s=chunk_deadline_s, report=report)
    out = x[:n]
    if normalized:
        nrm = float(np.linalg.norm(out))
        if nrm > 0:
            out = out / nrm
    return out, float(err), iters


def wcc_streamed(tier, max_iterations: int = 200, *, comp0=None,
                 resident: bool = False, stats=None,
                 checkpoint_every: int = 0, job: str | None = None,
                 store=None, retry=None, chunk_deadline_s=None,
                 report=None, device=None):
    """Weakly connected components over a host TierCSR (min-label
    propagation and pointer jumping).  Returns
    ``(labels[:n], changed, iters)``."""
    dev = resolve_device(device)
    dec = _Decoder(tier, dev)
    n, n_pad2 = tier.n_nodes, tier.n_pad2
    x0v = _x0(comp0, tier, np.arange(n_pad2, dtype=np.int32),
              pad_value=None, dtype=np.int32)

    def iterate(comp, env, sweep):
        def fold(cand, t, meta):
            src, dst = dec.indices(t, meta)
            # padding edges carry a REAL src (the block base) toward the
            # sink row: masked, or the sink merges unrelated components
            real = dec.iota < meta["rc"]
            fwd = torch.where(real, comp[src.long()], n_pad2)
            bwd = torch.where(real, comp[dst.long()], n_pad2)
            cand = cand.scatter_reduce_(0, dst.long(), fwd, reduce="amin")
            return cand.scatter_reduce_(0, src.long(), bwd, reduce="amin")

        cand = sweep(fold, torch.full((n_pad2,), n_pad2, dtype=torch.int32,
                                      device=dev))
        new = torch.minimum(comp, cand)
        new = new[new.long()]                 # pointer jump
        return new, (new != comp).any()

    comp, changed, iters = _tier_fixpoint(
        algo="wcc", tier=tier, device=dev, env_of=lambda sweep: {},
        iterate=iterate, x0=x0v, metric0=True,
        keep_going=lambda m: bool(m), max_iterations=max_iterations,
        resident=resident, stats=stats, checkpoint_every=checkpoint_every,
        job=job, store=store, retry=retry,
        chunk_deadline_s=chunk_deadline_s, report=report)
    return comp[:n], bool(changed), iters
