"""The graphed train step's host side (``GANTrainer._graphed_step``,
``training/graphs.py``, ``training/state.py``'s capturable Adam) on the
CPU, with ``graphs.CudaGraph`` stood in by ``FakeGraph``, at the size of
``tests/test_torch_spans.py`` (32 px, g/d/e_nch 8, batch 4).

``FakeGraph`` keeps a CUDA graph's contract: its capture runs nothing that
stays (it runs the code for its outputs, then puts the nets, Adam's state
and the step's generator back as they were), and each replay runs the code
again and writes the results into the captured outputs.  So the graphed
step's segments, static inputs and the tensors between them can be held
bit for bit against the eager step here; what the card adds (the captured
kernels themselves) is held in ``tests/test_torch_card.py``."""

import torch_one_thread  # noqa: F401  (first: one intra-op thread)

import dataclasses

import pytest
import torch

from srgan_tpu_torch.configs import PRESETS
from srgan_tpu_torch.training import gan, graphs
from srgan_tpu_torch.training.gan import GANTrainer
from srgan_tpu_torch.training.state import (
    adam,
    make_capturable,
    plain_state_dict,
    set_lr,
)
from srgan_tpu_torch.utils import spans
from srgan_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)

TOY = dict(image_size=32, g_nch=8, g_res_num=1, d_nch=8, d_num_cls=3,
           e_nch=8, e_num_cls=2)
B = 4


def toy(preset: str, **train):
    cfg = PRESETS[preset]()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **TOY),
        train=dataclasses.replace(cfg.train, batch_size=B, **train))


def batch(seed: int, b: int = B):
    g = torch.Generator().manual_seed(seed)
    src = torch.randint(0, 4, (b,), generator=g)
    return {"image": torch.rand((b, 32, 32, 3), generator=g) * 2 - 1,
            "source_label": src,
            "target_label": (src + torch.randint(1, 4, (b,), generator=g))
            % 4}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return []


class FakeGraph:
    """``graphs.CudaGraph`` on the CPU.  ``state`` is the train state the
    captured code updates (set by the test)."""

    state = None
    made = 0

    @staticmethod
    def pool():
        return None

    def __init__(self, pool, generator):
        FakeGraph.made += 1
        self.rng = generator
        self.replays = 0

    def capture(self, fn):
        st = FakeGraph.state
        nets = [net.state_dict() for net in (st.G, st.D, st.E)]
        nets = [{k: v.clone() for k, v in sd.items()} for sd in nets]
        moments = [[v.clone() for s in opt.state.values()
                    for v in s.values()]
                   for opt in (st.opt_g, st.opt_d, st.opt_e)]
        rng = self.rng.get_state()
        self.fn = fn
        self.out = fn()
        with torch.no_grad():
            for net, sd in zip((st.G, st.D, st.E), nets):
                net.load_state_dict(sd)
            for opt, saved in zip((st.opt_g, st.opt_d, st.opt_e), moments):
                for v, s in zip([v for s in opt.state.values()
                                 for v in s.values()], saved):
                    v.copy_(s)
        self.rng.set_state(rng)
        return self.out

    def replay(self):
        self.replays += 1
        with spans.tallied():
            new = self.fn()
        with torch.no_grad():
            for old, v in zip(_leaves(self.out), _leaves(new)):
                old.copy_(v)


def cpu_capturable(opt):
    """``make_capturable`` as far as the CPU's Adam goes: the rate a
    tensor (a capturable Adam's step refuses CPU parameters)."""
    for group in opt.param_groups:
        if not isinstance(group["lr"], torch.Tensor):
            group["lr"] = torch.tensor(float(group["lr"]))


@pytest.fixture
def graphed(monkeypatch):
    """Trainers built after this take the graphed step on the CPU."""
    monkeypatch.setattr(graphs, "CudaGraph", FakeGraph)
    monkeypatch.setattr(gan, "make_capturable", cpu_capturable)
    FakeGraph.made = 0
    yield
    FakeGraph.state = None


def pair(cfg, graph: bool):
    t = GANTrainer(cfg, "cpu")
    st = t.init_state(torch.Generator().manual_seed(3),
                      freeze_pretrained=cfg.pretrained_encoder)
    for opt in (st.opt_g, st.opt_d, st.opt_e):
        cpu_capturable(opt)
    if graph:
        t._graphable = lambda: True
        FakeGraph.state = st
    return t, st


def _snap(st):
    return ({n: p.detach().clone() for net in (st.G, st.D, st.E)
             for n, p in net.named_parameters()},
            [v.clone() for opt in (st.opt_g, st.opt_d, st.opt_e)
             for s in opt.state.values() for v in s.values()])


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


CASES = {
    "srgan_full": ("05_srgan_full", {}),
    "singlegan_k5": ("01_proposed_singlegan_k5", {}),
    "singlegan_k1_latent_restore": ("01_proposed_singlegan_k5", dict(
        unrolled_k=1, encoded_feature="latent", unrolled_restore=True)),
    "srgan_k3_restore_latent": ("03_srgan_nopretraining", dict(
        unrolled_k=3, unrolled_restore=True, encoded_feature="latent")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_steps_match_eager_bit_for_bit(case, graphed):
    """Eager, capture and replays at batch 4, then the partial batch's own
    eager call, capture and replay, an epoch change between them: every
    metric, parameter and Adam moment equal to the eager step's."""
    preset, train = CASES[case]
    cfg = toy(preset, **train)
    te, se = pair(cfg, graph=False)
    tg, sg = pair(cfg, graph=True)
    plan = [(0, B, 0), (1, B, 0), (2, B, 0), (3, 2, 0), (4, 2, 1),
            (5, 2, 1), (6, B, 1)]
    for seed, b, epoch in plan:
        me = te.step(se, batch(seed, b), epoch)
        mg = tg.step(sg, batch(seed, b), epoch)
        assert list(me) == list(mg)
        _same(me, mg)
        pe, oe = _snap(se)
        pg, og = _snap(sg)
        _same(pe, pg)
        assert all(torch.equal(a, b) for a, b in zip(oe, og))
    assert torch.equal(te.rng.get_state(), tg.rng.get_state())
    assert se.step == sg.step == len(plan)
    # no tensor the graphs hold carries an autograd graph: one would keep
    # the parameters' gradient accumulators alive from one step to the next
    for g in tg._graphs.values():
        held = _leaves([g.inputs, g.errD0, g.snapshot] + [
            seg.out for seg in (g.d_update, g.phase1, g.phase2) if seg])
        assert not any(t.requires_grad for t in held)
    # two batch sizes, three segments each (two without an unrolled D)
    assert sorted(tg._graphs) == [(2, "float32"), (B, "float32")]
    assert FakeGraph.made == 2 * (3 if cfg.train.unrolled_k > 1 else 2)


def test_replays_count_as_eager_steps(graphed):
    """The recording's counters of each step, the spans of each phase and
    ``state.step``: the same for the eager step, the capturing one and the
    replays."""
    cfg = toy("01_proposed_singlegan_k5")
    t, st = pair(cfg, graph=True)
    with spans.recording() as rec:
        for seed in range(4):
            t.step(st, batch(seed))
    steps = [s.id for s in rec.named(spans.STEP)]
    per_step = [{n: v for (n, step), v in rec.counters.items()
                 if step == sid} for sid in steps]
    assert per_step[0]["norm.fwd"] > 0 and per_step[0]["norm.bwd"] > 0
    assert all(c == per_step[0] for c in per_step)
    for name, n in (("train.d_update", 4), ("train.phase1", 1),
                    ("train.phase2", 1)):
        by_step = [sum(s.step == sid for s in rec.named(name))
                   for sid in steps]
        assert by_step == [n] * 4, name
    assert st.step == 4


def test_replays_add_the_captures_counts_to_the_totals(monkeypatch):
    """A capture keeps what its code counts, the kernels' launches
    (``launch.*``) and ``norm.*`` alike, out of the totals and the
    recording; each replay of the segment adds it to both."""
    class Capture(FakeGraph):
        def capture(self, fn):
            return fn()

        def replay(self):
            pass

    monkeypatch.setattr(graphs, "CudaGraph", Capture)
    names = ("launch.cbinorm_fwd", "norm.fwd")

    def code():
        spans.count(names[0], 2)
        spans.count(names[1], 3)
        return torch.zeros(())

    def totals():
        now = spans.totals()
        return [now.get(n, 0) for n in names]

    before = totals()
    with spans.recording() as rec:
        seg = graphs.Segment(code, None, torch.Generator())
        assert totals() == before and not rec.counters
        with spans.span(spans.STEP):
            seg.replay()
            seg.replay()
    assert [a - b for a, b in zip(totals(), before)] == [4, 6]
    assert {n: v for (n, _), v in rec.counters.items()} == {
        names[0]: 4, names[1]: 6}


def test_graph_cache_lr_tensor_and_copied_metrics(graphed):
    """Graphs by batch size, captured on the second call of each; an epoch
    change writes the new rates into the same tensors, with no capture;
    the metrics a replay returns are not the graphs' outputs, which the
    next replay rewrites."""
    cfg = toy("05_srgan_full", lr_gamma=0.5)
    t, st = pair(cfg, graph=True)
    lrs = [g["lr"] for opt in (st.opt_g, st.opt_d, st.opt_e)
           for g in opt.param_groups]
    t.step(st, batch(0))
    assert t._graphs == {(B, "float32"): None} and FakeGraph.made == 0
    t.step(st, batch(1))
    assert FakeGraph.made == 3
    g = t._graphs[(B, "float32")]
    m = t.step(st, batch(2), epoch=1)
    kept = {k: v.clone() for k, v in m.items()}
    t.step(st, batch(3), epoch=1)
    assert FakeGraph.made == 3 and g.phase2.graph.replays == 3
    _same(m, kept)
    statics = {v.data_ptr() for v in g.phase2.out.values()}
    assert not statics & {v.data_ptr() for v in m.values()}
    now = [grp["lr"] for opt in (st.opt_g, st.opt_d, st.opt_e)
           for grp in opt.param_groups]
    assert all(a is b for a, b in zip(lrs, now))
    assert [float(v) for v in now] == pytest.approx(
        list(t.lr_at(1)), rel=1e-6)
    t.step(st, batch(4, 2))
    assert sorted(t._graphs) == [(2, "float32"), (B, "float32")]
    assert t._graphs[(2, "float32")] is None and FakeGraph.made == 3


def test_cpu_and_mesh_paths_never_capture(monkeypatch):
    """The CPU steps eagerly and asks for no graph; on CUDA a mesh,
    ``SRGAN_TPU_FUSED_DIV=1`` or injected draws keep the step eager."""
    class NoGraph:
        @staticmethod
        def pool():
            raise AssertionError("a pool was asked for")

        def __init__(self, *a):
            raise AssertionError("a graph was made")

    monkeypatch.setattr(graphs, "CudaGraph", NoGraph)
    cfg = toy("01_proposed_singlegan_k5", unrolled_k=2)
    t, st = pair(cfg, graph=False)
    for seed in range(3):
        t.step(st, batch(seed))
    assert t._graphs == {} and not t._graphable()
    t.device = torch.device("cuda")
    assert t._graphable()
    monkeypatch.setenv("SRGAN_TPU_FUSED_DIV", "1")
    assert not t._graphable()
    monkeypatch.delenv("SRGAN_TPU_FUSED_DIV")
    t.mesh = object()
    assert not t._graphable()

    class Injected(GANTrainer):
        def _draw_latent(self, shape):
            return torch.zeros(shape)

    inj = Injected(cfg, "cpu")
    inj.device = torch.device("cuda")
    assert not inj._graphable()


def test_resume_from_a_graphed_checkpoint(graphed, tmp_path):
    """A checkpoint written by the graphed step loads into it again: the
    loaded optimizers and histogram target are new objects, so the graphs
    start over (an eager call, then a capture), and the run goes on as an
    eager twin that loaded the same checkpoint."""
    cfg = toy("05_srgan_full")
    tg, sg = pair(cfg, graph=True)
    for seed in range(3):
        tg.step(sg, batch(seed))
    save_checkpoint(str(tmp_path), sg, sg.step)
    te, se = pair(cfg, graph=False)
    restore_checkpoint(str(tmp_path), se)
    for seed in range(3, 6):
        tg.step(sg, batch(seed))
    restore_checkpoint(str(tmp_path), sg)
    for opt in (se.opt_g, se.opt_d, se.opt_e):
        cpu_capturable(opt)
    made = FakeGraph.made
    te.rng.set_state(tg.rng.get_state())
    for seed in range(6, 9):
        _same(te.step(se, batch(seed)), tg.step(sg, batch(seed)))
    assert FakeGraph.made == made + 3
    _same(_snap(se)[0], _snap(sg)[0])


def _adam_pair():
    torch.manual_seed(0)
    ps = [torch.nn.Parameter(torch.randn(3, 2)),
          torch.nn.Parameter(torch.randn(4))]
    qs = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    plain, cap = adam(ps, 0.5, 0.999), adam(qs, 0.5, 0.999)
    for opt, params in ((plain, ps), (cap, qs)):
        for p in params:
            p.grad = torch.ones_like(p)
        set_lr(opt, 1e-3)
        opt.step()
    return plain, cap


def test_capturable_adam_keeps_the_plain_state_dict():
    """``make_capturable``: the rate a 0-dim float32 tensor that
    ``set_lr`` writes in place, ``capturable`` on; its state dict as the
    plain Adam's (the rate a float, ``capturable`` off, each step count a
    CPU float32 tensor), so either loads the other's."""
    plain, cap = _adam_pair()
    make_capturable(cap)
    make_capturable(cap)
    group = cap.param_groups[0]
    lr = group["lr"]
    assert group["capturable"] and lr.dim() == 0 and lr.dtype == torch.float32
    set_lr(cap, 2e-3)
    assert cap.param_groups[0]["lr"] is lr and float(lr) == pytest.approx(
        2e-3)
    set_lr(cap, 1e-3)
    a, b = plain.state_dict(), cap.state_dict()
    assert a["param_groups"] == [
        dict(g, lr=pytest.approx(g["lr"])) for g in b["param_groups"]]
    assert type(b["param_groups"][0]["lr"]) is float
    for sa, sb in zip(a["state"].values(), b["state"].values()):
        assert sa.keys() == sb.keys()
        for k in sa:
            assert sb[k].device.type == "cpu" and sb[k].dtype == sa[k].dtype
            assert torch.equal(sa[k], sb[k]), k
    # the optimizer's own state is left capturable
    assert cap.param_groups[0]["capturable"] and cap.param_groups[0]["lr"] \
        is lr
    cap.load_state_dict(a)
    assert not cap.param_groups[0]["capturable"]
    make_capturable(cap)
    assert cap.param_groups[0]["capturable"]
    assert isinstance(cap.param_groups[0]["lr"], torch.Tensor)
    assert plain_state_dict(plain, plain.state_dict())["param_groups"] == \
        a["param_groups"]
