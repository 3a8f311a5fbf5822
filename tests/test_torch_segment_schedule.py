"""The schedules of the deterministic segment sums (memgraph_tpu_torch/ops/
segment_cuda.py, ``csrc/segment.cu``), replayed on the CPU.

The CUDA kernels cannot run here.  What can be checked is how they divide
their work, since that is Python the tests reach:

  * ``lane_sum`` (K2): a warp reduces a chunk of a column in registers
    (lane t holds rows 32k + t; h = 128, 64, 32 as adds of registers,
    h = 16 .. 1 as ``__shfl_down_sync``), and the partials level by level.
    ``lane_sum_schedule`` replays that mapping and must give the bits of
    ``lane_sum_reference`` (the halving tree of slices) in every form.
  * ``csr_spmm_sum`` (K1): the kernel's C entry shapes its launch from the
    longest run, which a graph counts once when it is built
    (``longest_csc_run``, ``longest_csr_run``) and which every fixpoint of
    the segment backend hands to the run sum with its runs.
  * The wrappers launch once a call, with the longest run and the scratch
    these functions give (the C library replaced by a recorder).
"""

import numpy as np
import pytest
import torch

from memgraph_tpu_torch.ops import segment_cuda as SC

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

FORMS = ("sum", "dot", "l1")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _lane_inputs(rows, lanes, seed):
    rng = np.random.default_rng(seed)
    # magnitudes over six decades: the order of the adds shows in the bits
    a = rng.random((rows, lanes)) * 10.0 ** rng.uniform(-3, 3, (rows, 1))
    return (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(rng.random((rows, lanes)).astype(np.float32)),
            torch.from_numpy(rng.random(rows).astype(np.float32)))


def _form(form, b, m):
    return {"sum": {}, "dot": {"m": m}, "l1": {"b": b}}[form]


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("form", FORMS)
def test_lane_sum_register_schedule_is_the_tree(form, lanes):
    """Rows 1 .. 3 * 256 + 7: one chunk, a ragged last chunk, and partials
    of a second level."""
    a, b, m = _lane_inputs(3 * SC.CHUNK + 7, lanes, seed=lanes)
    for rows in range(1, 3 * SC.CHUNK + 8):
        kw = _form(form, b[:rows], m[:rows])
        got = SC.lane_sum_schedule(a[:rows], **kw)
        want = SC.lane_sum_reference(a[:rows], **kw)
        assert torch.equal(_bits(got), _bits(want)), rows


@pytest.mark.parametrize("lanes", [1, 3, SC.WARP_LANES + 1, 40])
@pytest.mark.parametrize("rows", [0, 2 * SC.CHUNK ** 2 + 300])
def test_lane_sum_register_schedule_over_three_levels(rows, lanes):
    """Three levels of the tree (rows past 256^2), the empty input, and the
    lane counts of both kernel paths (warps alone; a block's shared copy)."""
    a, b, m = _lane_inputs(rows, lanes, seed=7)
    for form in FORMS:
        kw = _form(form, b, m)
        got = SC.lane_sum_schedule(a, **kw)
        assert torch.equal(_bits(got), _bits(SC.lane_sum_reference(a, **kw)))


def test_lane_sum_one_dimensional_schedule_is_a_scalar():
    a, _, m = _lane_inputs(300, 1, seed=3)
    got = SC.lane_sum_schedule(a[:, 0], m=m)
    assert got.dim() == 0
    assert torch.equal(_bits(got.view(1)),
                       _bits(SC.lane_sum_reference(a[:, 0], m=m).view(1)))


def _levels(rows, lanes):
    """Each level's input rows, the first level's included."""
    out = [rows]
    while max(1, -(-out[-1] // SC.CHUNK)) > 1:
        out.append(-(-out[-1] // SC.CHUNK))
    return out


@pytest.mark.parametrize("rows,lanes", [(0, 1), (256, 1), (257, 3),
                                        (2 ** 20, 1), (2 ** 20, 8),
                                        (2 ** 20, 9), (2 ** 20, 32),
                                        (2 ** 17 + 1, 65)])
def test_lane_sum_scratch_holds_every_level(rows, lanes):
    floats, tickets = SC.lane_sum_scratch(rows, lanes)
    levels = _levels(rows, lanes)
    tiles = 1 if lanes <= SC.WARP_LANES else -(-lanes // SC.LANE_TILE)
    assert floats == sum(r * lanes for r in levels[1:])
    assert tickets == sum(max(1, -(-r // SC.CHUNK)) * tiles
                          for r in levels[1:])
    if rows == 2 ** 20:
        assert levels == [2 ** 20, 4096, 16]


def _ptr(lengths):
    return torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])
                            .astype(np.int64))


def _in_degrees():
    """Run lengths of the CSC side: adversarial (no edges, one huge run,
    lengths around the kernel's short/long bound of 128) and random."""
    rng = np.random.default_rng(11)
    return {
        "no_edges": np.zeros(50, np.int64),
        "one_huge_run": np.array([0, 3, 2 ** 17 + 5, 0, 7]),
        "around_the_bound": rng.choice([0, 0, 127, 128, 129, 256, 4097],
                                       200),
        "all_short": rng.integers(0, 30, 2000),
        "random": rng.integers(0, 512, 3000),
        "skewed": np.bincount((rng.random(20000) ** 2 * 2000)
                              .astype(np.int64), minlength=2000),
    }


@pytest.mark.parametrize("builder", ["default", "numpy"])
@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("name", sorted(_in_degrees()))
def test_graph_records_its_longest_runs(monkeypatch, name, pad, builder):
    """A graph counts the longest run of each side once, when it is built:
    the largest in-degree (its CSC runs, ``csc_runs()``, padding left out)
    and out-degree (``row_ptr``), on the host and after placement."""
    from memgraph_tpu_torch.ops import csr, native
    if builder == "numpy":
        monkeypatch.setattr(native, "build_csr_csc_native",
                            lambda *a, **k: None)
    lengths = _in_degrees()[name]
    rng = np.random.default_rng(len(lengths))
    n = len(lengths)
    dst = np.repeat(np.arange(n), lengths)
    src = rng.integers(0, n, len(dst))
    g = csr.from_coo(src, dst, n_nodes=n, pad=pad)
    want_out = int(np.bincount(src, minlength=n).max(initial=0))
    assert g.longest_csc_run == int(lengths.max())
    assert g.longest_csr_run == want_out
    assert g.longest_csc_run == int(np.diff(g.csc_runs()).max())
    assert g.longest_csr_run == int(np.diff(g.row_ptr).max())
    placed = g.to_device("cpu")
    assert (placed.longest_csc_run, placed.longest_csr_run) == \
        (g.longest_csc_run, g.longest_csr_run)
    assert placed.longest_csc_run == int(
        (placed.csc_runs()[1:] - placed.csc_runs()[:-1]).max())


def _spy_graph():
    from memgraph_tpu_torch.ops import csr
    rng = np.random.default_rng(5)
    n = 300
    # node 0 collects a long run, the rest short ones
    dst = np.concatenate([np.zeros(400, np.int64), rng.integers(0, n, 900)])
    src = rng.integers(0, n, len(dst))
    return csr.from_coo(src, dst, n_nodes=n).to_device("cpu")


def _run_pagerank(g):
    from memgraph_tpu_torch.ops import pagerank as PR
    PR.pagerank(g, max_iterations=3, device="cpu")


def _run_ppr(g):
    from memgraph_tpu_torch.ops import pagerank as PR
    PR.personalized_pagerank(g, [0, 5], max_iterations=3, device="cpu")


def _run_ppr_batch(g):
    from memgraph_tpu_torch.ops import pagerank as PR
    PR.personalized_pagerank_batch(g, [[0], [1, 2], [7]], max_iterations=3,
                                   device="cpu")


def _run_katz(g):
    from memgraph_tpu_torch.ops import katz as K
    K.katz_centrality(g, alpha=0.01, max_iterations=3, device="cpu")


def _run_hits(g):
    from memgraph_tpu_torch.ops import katz as K
    K.hits(g, max_iterations=3, device="cpu")


@pytest.mark.parametrize("run", [_run_pagerank, _run_ppr, _run_ppr_batch,
                                 _run_katz, _run_hits])
def test_graph_paths_give_the_run_sum_their_longest_run(monkeypatch, run):
    """Every run sum of the segment backend's fixpoints is told its runs'
    longest, as the graph recorded it: CSC runs the longest in-degree,
    CSR runs the longest out-degree."""
    g = _spy_graph()
    real = SC.csr_spmm_sum
    seen = []

    def spy(x, ptr, *args, longest=None, **kw):
        seen.append((int((ptr[1:] - ptr[:-1]).max()), longest))
        return real(x, ptr, *args, longest=longest, **kw)

    monkeypatch.setattr(SC, "csr_spmm_sum", spy)
    run(g)
    assert seen
    assert all(have == given for have, given in seen), seen
    assert g.longest_csc_run in {have for have, _ in seen}


class _Recorder:
    """A stand-in for the CUDA library: records each entry point's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def csr_spmm_sum(self, *args):
        self.calls.append(("csr_spmm_sum", args))
        return 0

    def lane_sum(self, *args):
        self.calls.append(("lane_sum", args))
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(SC, "_lib", lambda: rec)
    monkeypatch.setattr(SC, "_on_card", lambda x, name: True)
    monkeypatch.setattr(SC, "_TICKETS", {})

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    SC.reset_launch_counts()
    yield rec
    SC.reset_launch_counts()


@pytest.mark.parametrize("lanes", [1, 3, 32])
def test_csr_spmm_sum_wrapper_launches_once_a_call(recorder, lanes):
    rng = np.random.default_rng(0)
    ptr = _ptr(np.array([0, 40, 3, 0, 100]))
    g = torch.from_numpy(rng.integers(0, 50, int(ptr[-1]))
                         .astype(np.int32))
    w = torch.ones(int(ptr[-1]))
    x = torch.ones(50, lanes)
    for call, longest in enumerate([None, 0, 29, 10016], start=1):
        SC.csr_spmm_sum(x, ptr, g, w, longest=longest)
        assert SC.csr_spmm_sum.launches == call
        assert len(recorder.calls) == call
        name, args = recorder.calls[-1]
        assert name == "csr_spmm_sum"
        # (..., n_seg, B, mul, bf16, longest, stream): the C entry takes
        # the launch shape from the longest run, -1 where it is unknown
        assert args[7:12] == (5, lanes, 1, 0,
                              -1 if longest is None else longest)
    assert SC.lane_sum.launches == 0


def test_csr_spmm_sum_refuses_a_negative_longest_run(recorder):
    with pytest.raises(ValueError, match="run length"):
        SC.csr_spmm_sum(torch.ones(4), _ptr(np.array([4])), mul="first",
                        longest=-2)
    assert recorder.calls == [] and SC.csr_spmm_sum.launches == 0


@pytest.mark.parametrize("call", ["spmv", "edge_reduce", "unsorted"])
def test_semiring_sums_pass_the_longest_run(recorder, call):
    """``spmv`` and ``edge_reduce`` hand their runs' longest to the run sum;
    runs found from the keys go with it unknown."""
    from memgraph_tpu_torch.ops import semiring as S
    dst = torch.tensor([0, 0, 0, 2, 3, 3], dtype=torch.int32)
    src = torch.tensor([1, 2, 3, 0, 1, 2], dtype=torch.int32)
    ptr = torch.tensor([0, 3, 3, 4, 6], dtype=torch.int32)
    w = torch.ones(6)
    if call == "spmv":
        S.spmv("plus_times", torch.ones(4), src, dst, w, n_out=4,
               sorted=True, ptr=ptr, longest=3)
    elif call == "edge_reduce":
        S.edge_reduce("sum", w, dst, 4, sorted=True, ptr=ptr, longest=3)
    else:
        S.edge_reduce("sum", w, dst.flip(0), 4, sorted=False, longest=3)
    (name, args), = recorder.calls
    assert name == "csr_spmm_sum"
    assert args[11] == (-1 if call == "unsorted" else 3)


@pytest.mark.parametrize("rows,lanes", [(0, 1), (300, 3), (70000, 32)])
def test_lane_sum_wrapper_launches_once_a_call(recorder, rows, lanes):
    a = torch.ones(rows, lanes)
    for form, kw in (("sum", {}), ("dot", {"m": torch.ones(rows)}),
                     ("l1", {"b": torch.zeros(rows, lanes)})):
        before = len(recorder.calls)
        SC.lane_sum(a, **kw)
        assert len(recorder.calls) == before + 1
        name, args = recorder.calls[-1]
        assert name == "lane_sum"
        floats, tickets = SC.lane_sum_scratch(rows, lanes)
        # (a, b, m, out, scratch, n_scratch, tickets, n_tickets, rows, B,
        #  form, stream): the scratch and zeroed tickets it needs
        assert args[5] == floats and args[7] >= tickets
        assert args[8:11] == (rows, lanes, SC._FORMS[form])
    assert SC.lane_sum.launches == 3
    assert SC.csr_spmm_sum.launches == 0
    held = next(iter(SC._TICKETS.values()))
    assert held.dtype == torch.int32 and not held.any()


def test_segment_against_needs_a_card(monkeypatch):
    from memgraph_tpu_torch.benchmarks import segment_against
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        segment_against.main([])


def test_segment_against_gives_the_longest_run_where_it_is_taken():
    """A build whose wrapper predates ``longest`` is called without it."""
    from memgraph_tpu_torch.benchmarks import segment_against

    class Old:
        @staticmethod
        def csr_spmm_sum(x, ptr, g=None, w=None, *, mul="times",
                         precision="f32"):
            return ("old", precision)

    class New:
        @staticmethod
        def csr_spmm_sum(x, ptr, g=None, w=None, *, mul="times",
                         precision="f32", longest=None):
            return ("new", precision, longest)

    args = (None, None, None, None, "bf16", 29)
    assert segment_against.k1_call(Old, *args, give_longest=True)() == \
        ("old", "bf16")
    assert segment_against.k1_call(New, *args, give_longest=True)() == \
        ("new", "bf16", 29)
    assert segment_against.k1_call(New, *args, give_longest=False)() == \
        ("new", "bf16", None)
