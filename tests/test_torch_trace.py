"""The port's spans and device marks (`utils/trace.py`) on the CPU.

Off, a sampler call leaves no record and opens no profiler event; on, its
spans nest under one call id a call, share the profiler's clock, and the
step's marks split each step into its parts; the maps are the same bits
either way. The set-up's spans do not overlap. The graphs' marks run on
the card: `tests/test_torch_kernels_gpu.py`.
"""

import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ccdm_tpu_torch import CITYSCAPES_EVAL_PARAMS
from ccdm_tpu_torch.diffusion import random
from ccdm_tpu_torch.diffusion import sampling
from ccdm_tpu_torch.eval.cityscapes_eval import CityscapesEvaluator
from ccdm_tpu_torch.eval.lidc_uncertainty import make_prob_sampler
from ccdm_tpu_torch.models.builder import build_model
from ccdm_tpu_torch.utils import trace
from torch_port_util import TINY_PARAMS

torch.set_num_threads(2)

B, S, H, T = 2, 2, 16, 4
STEP_PARTS = ["unet", "posterior", "noise", "draw"]


@pytest.fixture(autouse=True)
def off():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _model(c: int):
    model = build_model(dict(TINY_PARAMS, time_steps=T), num_classes=c, image_channels=1,
                        image_size=32, device="cpu", generator=torch.Generator().manual_seed(c))
    gen = torch.Generator().manual_seed(100 + c)
    with torch.no_grad():  # the zero leaves redrawn: a softmax that is not uniform
        for p in model.unet.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


@pytest.fixture(scope="module")
def models():
    return {2: _model(2), 9: _model(9)}


def _images(seed: int = 1):
    return torch.randn(B, H, H, 1, generator=torch.Generator().manual_seed(seed))


class _Counted:
    opened = 0

    def __init__(self, name):
        type(self).opened += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_off_a_call_leaves_no_record_and_opens_no_profiler_event(models, monkeypatch):
    monkeypatch.setattr(trace, "_ProfilerEvent", _Counted)
    _Counted.opened = 0
    model = models[9]
    make_prob_sampler(model, S)(model.unet, _images(), 3)
    assert trace.records() == [] and _Counted.opened == 0
    trace.mark("step", torch.device("cpu"))  # no span open and off: nothing to record into
    with trace.span("x") as rec:
        assert rec is None
    assert trace.records() == []


def test_on_spans_nest_under_one_call_id_a_call(models):
    trace.enable()
    model = models[2]
    run = make_prob_sampler(model, S)
    for key in (3, 4):
        run(model.unet, _images(), key)
    recs = trace.records()
    calls = [r for r in recs if r.name == "sampler.call"]
    assert len(calls) == 2 and calls[0].call != calls[1].call
    for call in calls:
        mine = [r for r in recs if r.call == call.call]
        assert call.parent is None
        assert sorted(r.name for r in mine) == sorted(
            ["sampler.call", "sampler.conditioning", "sampler.prior", "sampler.steps"])
        for r in mine:
            if r is not call:
                assert r.parent is call
                assert call.start_ns <= r.start_ns <= r.end_ns <= call.end_ns
    # the eager loop's steps mark their parts into the steps span: each
    # step's four parts, and the gap between steps
    steps = next(r for r in recs if r.name == "sampler.steps")
    assert steps.marks.names[:5] == ["step"] + STEP_PARTS
    # the last step draws nothing (K == T): no noise mark
    assert steps.marks.names.count("noise") == T - 1
    assert steps.marks.names.count("draw") == T
    ms = steps.marks.ms()
    assert set(ms) == {"step", *STEP_PARTS} and all(v >= 0 for v in ms.values())
    assert ms["unet"] > 0


def test_spans_share_the_profilers_clock(models):
    model = models[9]
    run = make_prob_sampler(model, S)
    for on in (False, True):
        trace.clear()
        if on:
            trace.enable()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run(model.unet, _images(), 3)
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("sampler.")]
        # an operator's event, not an annotation: no device range of its own
        assert events and not any(e.is_user_annotation() for e in events)
        assert sorted(e.name() for e in events) == sorted(
            ["sampler.call", "sampler.conditioning", "sampler.prior", "sampler.steps"])
        if not on:
            assert trace.records() == []
            continue
        by_name = {e.name(): e for e in events}
        for rec in trace.records():
            event = by_name[rec.name]
            assert abs(rec.start_ns - event.start_ns()) < 100_000, rec.name
            assert abs(rec.end_ns - event.start_ns() - event.duration_ns()) < 100_000


@pytest.mark.parametrize("c,reuse", [(2, 1), (2, 2), (9, 1), (9, 2)],
                         ids=["onehot", "onehot-r2", "index", "index-r2"])
def test_eager_maps_are_the_same_bits_with_tracing_on_and_off(models, c, reuse):
    model = models[c]
    run = make_prob_sampler(model, S, encoder_reuse=reuse)
    off = run(model.unet, _images(), 5)
    trace.enable()
    on = run(model.unet, _images(), 5)
    assert torch.equal(on, off)
    assert any(r.name == "sampler.steps" and r.marks.names for r in trace.records())


def test_graph_key_follows_the_tracing_state(models):
    """A capture holds marks only when tracing was on: a key each."""
    model = models[2]
    graphed = sampling.GraphedSampler(model.diffusion, sampling.SamplerConfig(T))
    xt = torch.zeros(B, H, H, 2)
    keys = random.element_keys(0, torch.arange(B), random.CHAIN)
    inputs = {"cond": torch.zeros(B, H, H, 1)}
    off = graphed.key(model.unet, xt, keys, inputs)
    trace.enable()
    assert graphed.key(model.unet, xt, keys, inputs) != off


def test_setup_stages_and_the_evaluators_spans(tmp_path):
    """The Cityscapes evaluator at base 16 with a tiny DINO: `setup.model`
    and `setup.dino` do not overlap; a call's `evaluator.predict` holds the
    sampler's call, DINO's span with its two marks, and the vote mean."""
    p = copy.deepcopy(CITYSCAPES_EVAL_PARAMS)
    p["unet_openai"]["base_channels"] = 16
    p["feature_cond_encoder"].update(source_layer=1, vit_config=dict(
        embed_dim=48, depth=2, num_heads=2, patch_size=8, pretrain_size=32))
    p["evaluation"]["evaluations"] = 1
    p.update(compute_dtype="float32", time_steps=2, output_path=str(tmp_path))
    trace.enable()
    ev = CityscapesEvaluator(p)
    ev.build((256, 512, 3), 1, device="cpu")
    ev.predict_batch(torch.randn(1, 64, 128, 3, generator=torch.Generator().manual_seed(0)))
    recs = trace.records()
    stages = sorted((r for r in recs if r.name.startswith("setup.")), key=lambda r: r.start_ns)
    assert [r.name for r in stages] == ["setup.model", "setup.dino"]
    assert stages[0].end_ns <= stages[1].start_ns
    assert all(r.parent is None for r in stages)
    predict = next(r for r in recs if r.name == "evaluator.predict")
    call = next(r for r in recs if r.name == "sampler.call")
    dino = next(r for r in recs if r.name == "dino.features")
    assert call.parent is predict and dino.parent.name == "sampler.conditioning"
    assert dino.call == call.call == predict.call != stages[0].call
    assert dino.marks.names == ["start", "dino"] and dino.marks.ms()["dino"] > 0
    # the vote mean runs in the predict span after the sampler's call
    assert trace.self_ms(predict, recs) > 0 and call.end_ns <= predict.end_ns


def _span(name, a, b, parent=None):
    rec = trace.Span(name, a, parent, parent.call if parent else 0)
    rec.end_ns = b
    return rec


def test_self_ms_counts_each_covered_interval_once():
    root = _span("sampler.call", 0, 10_000_000)
    kernels = _span("setup.kernels", 1_000_000, 4_000_000, root)
    inner = _span("sampler.capture", 2_000_000, 6_000_000, root)
    nested = _span("setup.model", 3_000_000, 5_000_000, inner)  # under a child
    other = _span("sampler.call", 20_000_000, 30_000_000)       # not a descendant
    recs = [root, kernels, inner, nested, other]
    assert trace.self_ms(root, recs) == pytest.approx(5.0)      # 10 - [1, 6]
    # only the named stages: a stage nested anywhere below counts in its own
    assert trace.self_ms(root, recs, {"setup.kernels", "setup.model"}) == pytest.approx(6.0)
    assert trace.self_ms(inner, recs) == pytest.approx(2.0)
    assert trace.self_ms(other, recs) == pytest.approx(10.0)


def test_marks_sum_each_gap_under_the_later_name():
    marks = trace.Marks()
    marks.names, marks.points = ["step", "unet", "draw", "step", "unet", "draw"], [
        0, 2_000_000, 2_500_000, 3_000_000, 5_500_000, 6_000_000]
    assert marks.ms() == pytest.approx({"unet": 4.5, "draw": 1.0, "step": 0.5})
    trace.enable()
    with trace.marking(trace.Marks()) as own, trace.span("outer") as rec:
        with trace.marking(own):
            trace.mark("a", torch.device("cpu"))
        trace.mark("b", torch.device("cpu"))
    assert own.names == ["a"] and rec.marks.names == ["b"]
    trace.attach("graph.drawing", own)  # no span open: nowhere to attach
    with trace.span("steps") as rec:
        trace.attach("graph.drawing", own)
    assert rec.attached == {"graph.drawing": own}


def test_each_spans_every_wait_for_the_next_item():
    trace.enable()
    assert list(trace.each("train.batch_wait", iter([1, 2, 3]))) == [1, 2, 3]
    waits = [r for r in trace.records() if r.name == "train.batch_wait"]
    assert len(waits) == 4  # three items and the end
    assert len({r.call for r in waits}) == 4


def test_the_split_phase_reads_a_traced_eager_call(models):
    """`tools/profile_sampler.py --split`'s reader on the eager loop: the
    call's host time outside its steps, its spans, and the steps' parts."""
    from ccdm_tpu_torch.tools import profile_sampler as ps

    model = models[2]
    run = make_prob_sampler(model, S)
    trace.enable()
    run(model.unet, _images(), 3)
    recs = trace.records()
    call = next(r for r in recs if r.name == "sampler.call")
    steps = next(r for r in recs if r.name == "sampler.steps")
    out = ps.call_split(call, recs, ps.graph_replays(T, 1, graphs=False))
    assert set(out["spans_ms"]) == {"sampler.conditioning", "sampler.prior", "sampler.steps"}
    assert out["host_ms"] == pytest.approx(call.ms - steps.ms)
    assert out["dino_ms"] is None
    parts = out["parts_ms"]["eager"]
    assert set(parts) == {"step", *STEP_PARTS}
    assert out["marked_steps_ms"] == pytest.approx(sum(parts[k] for k in STEP_PARTS))
    assert 0 < out["marked_steps_ms"] <= steps.ms


@pytest.mark.parametrize("k,reuse,want", [
    (250, 1, {"graph.drawing": 249, "graph.last": 1}),
    (5, 2, {"graph.drawing": 2, "graph.reuse": 2, "graph.last": 1}),
], ids=["r1", "r2"])
def test_the_split_phase_counts_each_graphs_replays(k, reuse, want):
    from ccdm_tpu_torch.tools import profile_sampler as ps

    assert ps.graph_replays(k, reuse, graphs=True) == want
    assert ps.graph_replays(k, reuse, graphs=False) == {"eager": 1}


def test_the_split_phases_setup_stages_do_not_overlap():
    from ccdm_tpu_torch.tools import profile_sampler as ps

    model = _span("setup.model", 0, 5_000_000)
    kernels = _span("setup.kernels", 1_000_000, 3_000_000, model)  # loaded inside the build
    dino = _span("setup.dino", 5_000_000, 6_000_000)
    first = _span("sampler.call", 7_000_000, 17_000_000)
    late = _span("setup.kernels", 8_000_000, 9_000_000, first)
    again = _span("sampler.call", 20_000_000, 21_000_000)
    stages = ps.setup_stages([kernels, model, dino, late, first, again])
    assert stages == pytest.approx({"kernels": 0.003, "model": 0.004, "first_call": 0.009})
    assert ps.union_ms([(0, 2_000_000), (1_000_000, 3_000_000), (5_000_000, 6_000_000)]) == \
        pytest.approx(4.0)


class _Event:
    def __init__(self, name, a, b, cuda=False, corr=0):
        self._name, self._a, self._b, self._cuda, self._corr = name, a, b, cuda, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return 0


def test_the_split_phases_profiled_check_on_synthetic_events():
    """Two steps replayed by two graph launches, one eager kernel before
    them."""
    from ccdm_tpu_torch.tools import profile_sampler as ps

    ms = 1_000_000
    events = [_Event("sampler.call", 0, 10 * ms),
              _Event("cudaGraphLaunch", 2 * ms, 3 * ms, corr=7),
              _Event("cudaGraphLaunch", 3 * ms, 4 * ms, corr=8),
              _Event("prior_kernel", 1 * ms, 2 * ms, cuda=True, corr=5),
              _Event("a", 3 * ms, 6 * ms, cuda=True, corr=7),
              _Event("b", 6 * ms, 9 * ms, cuda=True, corr=8)]
    out = ps.profiled_check(events, {"host_ms": 3.5, "marked_steps_ms": 6.2}, steps=2)
    assert out["host_ms"] == 3.5 and out["replay_kernels"] == 2
    assert out["step_device_ms"] == pytest.approx(3.5)      # 7 ms busy over 2 steps
    assert out["other_device_ms"] == pytest.approx(1.0)
    assert out["predicted_step_device_ms"] == pytest.approx(3.6)
