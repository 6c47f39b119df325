"""The dry run's composed peak (`repro_torch.launch.dryrun.compose_regions`,
`compose`, `trace_cell`) against a trace of the whole step.

The reference's dry run reads the whole step's peak from XLA's memory
analysis.  The port traces a train or prefill step at 2 and 3 groups and
composes the full depth; a peak is a maximum over the step, not a sum,
so it is composed region by region (the step's start, each layer of each
microbatch's forward and backward, the turns between them, each AdamW
leaf) and the cell is traced whole where the probes do not fit the rule.

- one device, no world: granite-3-8b's smoke config widened (d 512, F
  2048, 8 heads, vocab 32768, remat) trains 16 x 256; its 2- and 3-group
  probes peak on one AdamW leaf, the 24-group step on another, whose
  temporaries grow with the stack: every region of the 24-group trace,
  and so its peak, equals the composed one (a line through the probes'
  peaks reads 2 550 673 424 bytes where the step holds 2 651 336 720);
- the region record leaves a whole trace's counts and peak as they were;
- the rule on synthetic regions: two once-only regions whose lines cross
  past the probes, and the three ways probes fail to fit it, each of
  which sends the cell to a whole trace; a leaf AdamW updates in runs of
  rows at full depth and whole in a probe does too.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models.sharding import make_policy  # noqa: E402

CPU = torch.device("cpu")
#: the fields a composed record takes from the probes by the linear rule
COUNTS = ("flops", "flops_by_op", "bytes", "collective_bytes",
          "collective_counts", "collective_bytes_by_kind",
          "arg_bytes_per_dev", "out_bytes_per_dev", "alias_bytes_per_dev")
#: the one-device reproduction: the depth past its crossover (the probes'
#: peak is another leaf's from about 16 groups on)
DEEP = 24


def _widened_granite():
    return dataclasses.replace(
        get_config("granite-3-8b", smoke=True), remat=True, d_model=512,
        d_ff=2048, num_heads=8, kv_heads=8, vocab=32768)


@pytest.fixture(scope="module")
def deep():
    """The reproduction's probes and its 24-group step, traced once."""
    cfg, shape = _widened_granite(), D.C.Shape("t", 256, 16, "train")
    two, three, whole = (D.trace_step(D.at_groups(cfg, g), shape, None, CPU)
                         for g in (*D.PROBE_GROUPS, DEEP))
    return {"two": two, "three": three, "whole": whole}


def test_the_probes_peak_where_the_deep_step_does_not(deep):
    """The crossover itself: a line through the probes' peaks (how the
    peak was once composed) misses the 24-group step's."""
    two, three = (deep[k]["peak_bytes_per_dev"] for k in ("two", "three"))
    assert (deep["two"]["peak_region"], deep["three"]["peak_region"]) == (
        "adamw leaf 9", "adamw leaf 9")
    assert deep["whole"]["peak_region"] == "adamw leaf 2"
    assert two + (DEEP - 2) * (three - two) == 2_550_673_424
    assert deep["whole"]["peak_bytes_per_dev"] == 2_651_336_720


def test_composed_peak_equals_a_traced_deep_step(deep):
    composed = D.compose(deep["two"], deep["three"], DEEP)
    whole = deep["whole"]
    for k in COUNTS:
        assert composed[k] == whole[k], k
    for k in ("peak_bytes_per_dev", "tmp_bytes_per_dev", "peak_region"):
        assert composed[k] == whole[k], k
    assert composed["peak_from"] == "composed"


def test_every_region_of_the_deep_step_is_composed(deep):
    """Not the peak alone: each region's peak at 24 groups, the step's
    start, 24 x 4 x 2 layer regions, the turns, stacks and gradients of
    each microbatch and each leaf's norm and AdamW update, equals the
    composed one."""
    composed = D.compose_regions(deep["two"], deep["three"], DEEP)
    traced = {tuple(k): v for k, v, _ in deep["whole"]["regions"]}
    assert len(traced) == 235
    assert composed == traced


def test_trace_cell_composes_the_deep_step(deep, monkeypatch):
    """``trace_cell`` takes the composed path at 24 groups (the probes
    are not traced again: ``trace_step`` hands back the fixture's)."""
    by_groups = {2: deep["two"], 3: deep["three"]}
    monkeypatch.setattr(D, "trace_step", lambda cfg, *a, **k: dict(
        by_groups[cfg.num_groups]))
    rec, policy = D.trace_cell(D.at_groups(_widened_granite(), DEEP),
                               D.C.Shape("t", 256, 16, "train"), None,
                               device="cpu")
    assert policy is None and rec["peak_from"] == "composed"
    assert rec["peak_bytes_per_dev"] == deep["whole"]["peak_bytes_per_dev"]
    assert "regions" not in rec


# ---------------------------------------------------------------------------
# the region record adds no op and moves no peak
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,remat", [("train", False), ("train", True),
                                        ("prefill", False)])
def test_region_record_leaves_a_whole_trace_unchanged(kind, remat,
                                                      monkeypatch):
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              remat=remat)
    shape = (D.C.Shape("t", 64, 8, "train") if kind == "train"
             else D.C.Shape("p", 256, 4, "prefill"))
    marked = D.trace_step(cfg, shape, None, CPU)
    monkeypatch.setattr(D.CostMode, "marking_regions", lambda self: None)
    plain = D.trace_step(cfg, shape, None, CPU)
    assert [k for k, _, _ in plain["regions"]] == [["start"]]
    for k in (*COUNTS, "peak_bytes_per_dev", "tmp_bytes_per_dev"):
        assert marked[k] == plain[k], k
    # the regions cover the step: their largest is the peak
    assert max(v for _, v, _ in marked["regions"]) == \
        marked["peak_bytes_per_dev"]
    layers = [k for k, _, _ in marked["regions"] if k[0] == "layer"]
    passes = 2 * D.MICROBATCH if kind == "train" else 1
    assert len(layers) == passes * cfg.num_layers


# ---------------------------------------------------------------------------
# the rule on synthetic regions
# ---------------------------------------------------------------------------
def _probe(regions: dict) -> dict:
    """A probe's record: ``regions`` maps a label to its peak (a layer
    region's label ends in g); the counts are zero."""
    rec = {k: 0 for k in COUNTS}
    rec.update(flops_by_op={}, collective_counts={},
               collective_bytes_by_kind={})
    rec["regions"] = [[list(k), v, None if k[0] == "layer" else [v]]
                      for k, v in regions.items()]
    rec["peak_bytes_per_dev"] = max(regions.values())
    return rec


def _layers(values_by_g, mb=0, phase="fwd"):
    return {("layer", mb, phase, 0, g): v for g, v in enumerate(values_by_g)}


def test_once_only_regions_whose_lines_cross_past_the_probes():
    """The head's region holds more at 2 and 3 groups, the gradients'
    grows faster and holds more from 5 groups on; a line through the
    probes' peaks (the head's) reads 130 at 5 groups, the step 135."""
    two = _probe({("start",): 50, ("turn", 0, "fwd"): 100,
                  ("grads", 0): 90, **_layers([60, 70])})
    three = _probe({("start",): 55, ("turn", 0, "fwd"): 110,
                    ("grads", 0): 105, **_layers([65, 75, 85])})
    regions = D.compose_regions(two, three, 5)
    assert regions[("turn", 0, "fwd")] == 130
    assert regions[("grads", 0)] == 135
    # a layer region: 5 a group at g = 0 and 1, 10 a group before it
    assert [regions[("layer", 0, "fwd", 0, g)] for g in range(5)] == [
        75, 85, 95, 105, 115]
    rec = D.compose(two, three, 5)
    assert (rec["peak_bytes_per_dev"], rec["peak_region"]) == (
        135, "mb 0 gradients")
    assert rec["tmp_bytes_per_dev"] == 135 and rec["peak_from"] == "composed"
    assert D.compose(two, three, 3)["peak_region"] == "mb 0 head and loss"


def test_a_once_only_region_is_composed_op_by_op():
    """Two places in one region (its live count after each op): the
    second grows faster and sets the region's peak past the probes."""
    two, three = _probe({("start",): 100}), _probe({("start",): 110})
    two["regions"][0][2] = [100, 95]
    three["regions"][0][2] = [110, 108]
    assert D.compose_regions(two, three, 6)[("start",)] == 147


@pytest.mark.parametrize("case", ["a region in one probe only",
                                  "a group's growth differs",
                                  "a region falls with the depth"])
def test_probes_that_do_not_fit_send_the_cell_whole(case, monkeypatch):
    two = {("start",): 50, **_layers([60, 70])}
    three = {("start",): 55, **_layers([65, 75, 85])}
    if case == "a region in one probe only":
        three[("turn", 0, "fwd")] = 40
    elif case == "a group's growth differs":
        # 10 from group 0 to 1 at 2 groups, 12 at 3 (c 5 at group 0, 7
        # at group 1)
        three.update(_layers([65, 77, 87]))
    else:
        three[("start",)] = 45
    two, three = _probe(two), _probe(three)
    with pytest.raises(D.ProbesDoNotFit):
        D.compose(two, three, 6)
    # trace_cell traces the step whole instead
    whole = dict(_probe({("start",): 999}), peak_region="start")
    monkeypatch.setattr(D, "trace_step", lambda cfg, *a, **k: dict(
        {2: two, 3: three}.get(cfg.num_groups, whole)))
    cfg = D.at_groups(get_config("granite-3-8b", smoke=True), 6)
    rec, _ = D.trace_cell(cfg, D.C.Shape("t", 64, 8, "train"), None,
                          device="cpu")
    assert rec["peak_from"] == "whole" and rec["peak_bytes_per_dev"] == 999
    assert rec["whole_why"].startswith("the probes do not fit")
    assert "regions" not in rec


def test_a_leaf_chunked_only_at_full_depth_sends_the_cell_whole(monkeypatch):
    """internlm2-20b's three MLP stacks on the 1-pod mesh: each local
    shard (G, 6144, 1024) is updated whole at 2 groups and in 48 runs of
    one row at 48 (more than 2**27 elements); granite-3-8b's stay whole
    at 40."""
    mesh = {"data": 16, "model": 16}
    shape = D.C.SHAPES["train_4k"]
    chunked = {}
    for arch in ("internlm2-20b", "granite-3-8b"):
        cfg = get_config(arch)
        pol = make_policy(mesh, cfg, batch=shape.global_batch, train=True,
                          hbm_bytes=80e9)
        chunked[arch] = (sum(D._chunking(D.at_groups(cfg, 2), pol)),
                         sum(D._chunking(cfg, pol)))
    assert chunked == {"internlm2-20b": (0, 3), "granite-3-8b": (0, 0)}
    depths = []

    def trace_step(cfg, *a, **k):
        depths.append(cfg.num_groups)
        return _probe({("start",): 1})

    monkeypatch.setattr(D, "trace_step", trace_step)
    rec, _ = D.trace_cell(get_config("internlm2-20b"), shape, mesh,
                          device="cpu")
    assert depths == [48] and rec["peak_from"] == "whole"
    assert rec["whole_why"] == ("a leaf's chunking in AdamW changes with "
                                "the depth")
