"""The port's spans (`repro_torch.obs`): off without a profiler, one set
a farm window and nested under one, and stamped on the profiler's own
clock.  Imports only the port, so the card's case runs where JAX is
absent:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_obs.py
"""

import types
from collections import Counter, defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core.cipher import CipherBatch  # noqa: E402
from repro_torch.core.farm import KeystreamFarm, WindowPlan  # noqa: E402

TOP = ("farm.produce", "farm.consume", "farm.encrypt")
PRODUCE = ("cipher.tables", "producer.upload", "producer.xof",
           "producer.uniform", "producer.gauss")


@pytest.fixture(autouse=True)
def _fresh():
    obs.clear()
    yield
    obs.clear()


def _farm(name="rubato-128s", sessions=3, device="cpu", producer=None,
          **kw):
    batch = CipherBatch(name, seed=7, producer=producer, device=device)
    batch.add_sessions(sessions)
    return batch, KeystreamFarm(batch, **kw)


def _jobs(batch, windows, blocks=4, rotate_at=None):
    """(plan, messages) of ``windows`` windows, every session's next
    ``blocks`` counters; session 0 rotates before window ``rotate_at``."""
    sids = np.repeat(np.arange(len(batch.sessions)), blocks)
    for i in range(windows):
        if i == rotate_at:
            batch.rotate_session(0)
        ctrs = np.concatenate([s.take_window(blocks)
                               for s in batch.sessions])
        msg = torch.linspace(-1, 1, sids.size * batch.params.l,
                             device=batch.device).reshape(sids.size, -1)
        yield WindowPlan(sids, ctrs, meta=i), msg


def _encrypt(batch, farm, windows, **kw):
    return [ct.cpu() for _, ct in farm.encrypt_stream(
        _jobs(batch, windows, **kw))]


def _profiler_spans(prof):
    """(name, start ns, end ns) of the profiler's host events named as the
    program's spans."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CPU
                and e.name().split(".")[0] in ("farm", "cipher", "producer")):
            out.append((e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return out


def _assert_inside_profiler_events(prof, recs):
    by_name = defaultdict(list)
    for name, a, b in _profiler_spans(prof):
        by_name[name].append((a, b))
    mine = defaultdict(list)
    for r in recs:
        mine[r.name].append(r)
    assert set(mine) == set(by_name)
    for name, rs in mine.items():
        evs = sorted(by_name[name])
        assert len(evs) == len(rs), name
        for r, (a, b) in zip(sorted(rs, key=lambda r: r.start_ns), evs):
            assert a <= r.start_ns <= r.end_ns <= b, (name, a, r, b)


def test_off_without_a_profiler(monkeypatch):
    calls = Counter()
    real_fn = torch._C._profiler._RecordFunctionFast

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(obs, "time", types.SimpleNamespace(
        time_ns=counted("time_ns", lambda: 0)))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counted("range", real_fn))
    batch, farm = _farm()
    _encrypt(batch, farm, 3, rotate_at=1)
    assert obs.records() == []
    assert calls == Counter()
    assert obs.span("farm.produce") is obs.span("x", stream=batch.device)


def test_spans_nest_one_set_a_window():
    batch, farm = _farm(depth=2)
    _encrypt(batch, farm, 1)              # a window before the profiler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _encrypt(batch, farm, 3, rotate_at=1)
    recs = obs.records()
    counts = Counter(r.name for r in recs)
    for name in TOP + ("producer.upload", "producer.xof",
                       "producer.uniform", "producer.gauss"):
        assert counts[name] == 3, name
    # depth 2: the second window is produced before the first is consumed
    assert [r.name.split(".")[1] for r in recs if r.name in TOP] == [
        "produce", "produce", "consume", "encrypt", "produce", "consume",
        "encrypt", "consume", "encrypt"]
    # the rotation before the second window re-stacks the tables once
    produce = [r for r in recs if r.name == "farm.produce"]
    (tables,) = [r for r in recs if r.name == "cipher.tables"]
    assert tables.parent is produce[1]
    for r in recs:
        if r.name in TOP:
            assert r.parent is None
        else:
            assert r.name in PRODUCE
            assert r.parent.name == "farm.produce"
            assert r.parent.start_ns <= r.start_ns <= r.end_ns \
                <= r.parent.end_ns
        assert r.device_ms is None          # no device stream on the CPU
    _assert_inside_profiler_events(prof, recs)


def test_spans_change_no_output():
    off = _encrypt(*_farm(), 3, rotate_at=1)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _encrypt(*_farm(), 3, rotate_at=1)
    assert obs.records()
    for a, b in zip(off, on):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_split_planes_produce_twice_a_window():
    batch, farm = _farm("pasta-128s", depth=2, matrix_depth=2)
    with profile(activities=[ProfilerActivity.CPU]):
        _encrypt(batch, farm, 3)
    counts = Counter(r.name for r in obs.records())
    assert counts["farm.produce"] == 6      # the matrix and vector planes
    assert counts["farm.consume"] == counts["farm.encrypt"] == 3


def test_threefry_opens_the_xof_span():
    batch, farm = _farm("hera-80", producer="threefry")
    with profile(activities=[ProfilerActivity.CPU]):
        _encrypt(batch, farm, 2)
    xof = [r for r in obs.records() if r.name == "producer.xof"]
    assert len(xof) == 2
    assert all(r.parent.name == "farm.produce" for r in xof)


def test_clear_drops_the_records():
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("farm.encrypt") as outer, obs.span("inner") as inner:
            pass
    assert obs.records() == [outer, inner]
    assert inner.parent is outer
    assert inner.under("farm.encrypt") and not outer.under("inner")
    obs.clear()
    assert obs.records() == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_device_spans_on_the_card(card):
    batch, farm = _farm("rubato-128l", sessions=64, device=card)
    _encrypt(batch, farm, 2, blocks=256)    # builds the kernels
    obs.clear()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        # a backlog on the producer's stream, so each stage's events
        # bracket its own work and not the host's enqueueing
        with torch.cuda.stream(farm._stream):
            torch.cuda._sleep(50_000_000)
        for _ in farm.encrypt_stream(_jobs(batch, 3, blocks=256)):
            pass
        torch.cuda.synchronize(card)
    recs = obs.records()
    staged = [r for r in recs if r.name in ("producer.xof",
                                            "producer.uniform",
                                            "producer.gauss")]
    assert len(staged) == 9
    assert all(r.device_ms > 0 for r in staged)
    kinds = ("kernel", "gpu_memcpy", "gpu_memset")
    ops = [e for e in prof.profiler.kineto_results.events()
           if (e.activity_type() in kinds if hasattr(e, "activity_type")
               else e.device_type() == DeviceType.CUDA)]
    # the producer's stream: the one the AES XOF kernel ran on
    (side,) = {e.device_resource_id() for e in ops
               if "aes_xof_kernel" in e.name()}
    busy = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in ops
            if e.device_resource_id() == side]
    # the spans lay no range over the device's timeline
    assert not {e.name() for e in ops} & {r.name for r in recs}
    merged, end = 0, 0
    for a, b in sorted(busy):
        merged += max(0, b - max(a, end))
        end = max(end, b)
    assert sum(r.device_ms for r in staged) * 1e6 <= merged
    _assert_inside_profiler_events(prof, recs)
