"""The port's step programs (``utils/programs.py`` and the functions it
captures on the card) against css_tpu's compiled steps, on the CPU.

On the CPU a program runs its function directly, so these tests hold the
functions the card captures: the sync-free train step and its optax
chain, G same-shape steps at once fed by the epoch's grouping, the
loader's regrouping, the schedule on a count tensor, and the absence of
any read from the device to the host in the separator forward, the train
and eval steps and the hop step. Small widths: a Conformer of 2 blocks x
64 (4 heads, kernel 7) at dropout 0 and a BLSTM of hidden 32, float32,
batches from the port's mixer with numpy seeds.

The port's steps are fed css_tpu's features (as
tests/test_torch_train_trainer.py explains: the two float32 STFTs differ
by ~5e-6 and the per-bin MVN of near-silent bins amplifies that), looked
up by the batch's mixture.

Tolerances. (1) and (2): 1e-5 relative on the loss, the gradient norm,
the logged rate and the BatchNorm statistics, and for params and Adam's
moments the L2 distance of each tensor within 1e-5 of the larger of its
norm and 1e-2 of the largest tensor's: the two packages sum float32 in
other orders, which moves a gradient by ~1e-5 of its tensor's norm
(tests/test_torch_train_trainer.py holds gradients to 1e-4), and an
init-zero bias or a one-element scale that a few updates moved has no
relative precision of its own; counts equal. Adam's tensors leave out the
parameters whose gradient is 0 in exact arithmetic (below 1e-6 of the
largest: the k bias and the biases ahead of BatchNorm), whose rounding
noise Adam turns into steps of ~lr in either package (``ROADMAP.md``,
Queue 3, "Adam moves null-gradient parameters by rounding noise"), and
the BatchNorm means take 0.2 times the rates applied so far for the same
reason, as tests/test_torch_train_trainer.py. G = 4 against the port's
own G = 1 on one thread: bit-equal. (4) The schedule: equal in float32
where it holds no exponential; in the decay phase within one float32
ulp, because XLA's float32 ``exp`` is not the correctly rounded one and
neither is torch's (they disagree by an ulp on ~0.4-20% of arguments).
"""

import contextlib
import hashlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.data.loader import PrefetchLoader as JLoader
from css_tpu.models import blstm as jb
from css_tpu.models import conformer as jc
from css_tpu.objectives.mse import MeanSquaredError as JMse
from css_tpu.trainer import LRSchedule as JSchedule
from css_tpu.trainer import Trainer as JTrainer
from css_tpu_torch.data.corpus import SyntheticCorpus
from css_tpu_torch.data.loader import PrefetchLoader
from css_tpu_torch.data.mixer import MixtureSynthesizer
from css_tpu_torch.executor.hop_streaming import HopStreamingPipeline
from css_tpu_torch.executor.separator import Separator
from css_tpu_torch.models import build_model, from_jax
from css_tpu_torch.objectives.mse import MeanSquaredError
from css_tpu_torch.trainer.checkpoint import tree_leaves
from css_tpu_torch.trainer.lr_schedule import LRSchedule
from css_tpu_torch.trainer.loop import Trainer
from css_tpu_torch.utils import programs

CONF = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
        "conformer_linear_units": 128, "conformer_num_blocks": 2,
        "conformer_kernel_size": 7, "conformer_dropout_rate": 0.0}
BLSTM_CONF = {"blstm_hdim": 32, "blstm_num_layers": 2,
              "blstm_dropout_rate": 0.0}
SCHED = dict(lr=1e-3, warmup=2, fixed=1, decay=0.2, min_lr=1e-4)
THRESH = 1.5  # the clip: active on the loud batch only (asserted)
LOUD = 20.0  # that batch's gain
REL = 1e-5


def _mixer(seed, windows):
    """One batch of 3 a window length (seconds), each from its own seed."""
    corpus = SyntheticCorpus(num_speakers=4, utts_per_speaker=2,
                             min_dur=2.0, max_dur=3.0, seed=3)
    out = []
    for i, w in enumerate(windows):
        ds = MixtureSynthesizer(corpus, batch_size=3, min_window=w,
                                max_window=w, seed=seed + i)
        out.append({k: v for k, v in next(ds).items()
                    if k not in ("ovl", "lens")})
    return out


@pytest.fixture(scope="module")
def batches():
    """Six 1.0 s batches: the third louder (the clip binds there), the
    fifth with a NaN sample."""
    bs = _mixer(4, [1.0] * 6)
    bs[2] = {k: v * LOUD for k, v in bs[2].items()}
    bs[4]["mix"] = bs[4]["mix"].copy()
    bs[4]["mix"][0, 100] = np.nan
    return bs


def _key(mix) -> str:
    return hashlib.sha1(np.ascontiguousarray(
        np.asarray(mix, np.float32)).tobytes()).hexdigest()


class _ReferenceFeatures:
    """The port's ``featurize`` replaced by css_tpu's features of the same
    batch, looked up by its mixture."""

    def __init__(self, jt):
        self.jt, self.table = jt, {}

    def add(self, batch):
        feats = self.jt._featurize(jax.tree.map(jnp.asarray, batch))
        self.table[_key(batch["mix"])] = {
            k: torch.as_tensor(np.array(v)) for k, v in feats.items()}

    def __call__(self, dbatch):
        return self.table[_key(dbatch["mix"].detach().numpy())]


def _pair(optim, model="conformer", sched=SCHED, thresh=THRESH, wd=1e-2,
          example=None):
    """(css_tpu trainer, its state, the port's trainer) on one weights,
    the BatchNorm statistics moved off their init."""
    if model == "conformer":
        jm, conf = jc.Conformer.build_model(CONF), CONF
    else:
        jm, conf = jb.BLSTM.build_model(BLSTM_CONF), BLSTM_CONF
    jt = JTrainer(jm, JMse(noise_weight=0.3), JSchedule(**sched),
                  optim=optim, weight_decay=wd, grad_thresh=thresh,
                  donate=False)
    state = jt.init_state(jax.random.PRNGKey(0), example)
    rng = np.random.default_rng(1)
    stats = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(
        0.1, 0.3, np.shape(a)).astype(np.float32), state.batch_stats)
    state = state.replace(batch_stats=jax.tree.map(jnp.asarray, stats))
    tm = build_model(type(jm).__name__, conf)
    tm.load_state_dict(from_jax(tm, jax.tree.map(np.asarray, state.params),
                                stats or None))
    tt = Trainer(tm, MeanSquaredError(noise_weight=0.3), LRSchedule(**sched),
                 optim=optim, weight_decay=wd, grad_thresh=thresh,
                 device="cpu")
    ref = _ReferenceFeatures(jt)
    tt.featurize = ref
    return jt, state, tt, ref


def _close_leaves(got, want, skip=(), label=""):
    """Each leaf within REL relative L2 of css_tpu's, relative to the
    larger of its own norm and 1e-2 of the largest leaf's."""
    got = [np.asarray(g, np.float64) for g in got]
    want = [np.asarray(w, np.float64) for w in want]
    top = max(float(np.linalg.norm(w)) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        if i in skip:
            continue
        err = float(np.linalg.norm(g - w))
        scale = max(float(np.linalg.norm(w)), 1e-2 * top)
        assert err <= REL * scale, (label, i, err / scale)


def _vanishing(jt, state, batch):
    """Indices (jax.tree.leaves order of the params) whose gradient is 0
    in exact arithmetic: below 1e-6 of the largest."""
    feats = jt._featurize(jax.tree.map(jnp.asarray, batch))
    _, grads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True),
                       static_argnums=(4,))(
        state.params, state.batch_stats, feats, jax.random.PRNGKey(0), True)
    tops = [float(np.abs(np.asarray(g)).max())
            for g in jax.tree.leaves(grads)]
    return {i for i, t in enumerate(tops) if t < 1e-6 * max(tops)}


def _compare_state(tt, state, skip, walk):
    ts = tt.state()
    assert ts.step == int(state.step)
    _close_leaves(tree_leaves(ts.params), jax.tree.leaves(state.params),
                  skip, "params")
    ws = _flat_stats(jax.tree.map(np.asarray, state.batch_stats))
    gs = _flat_stats(ts.batch_stats)
    assert set(gs) == set(ws)
    for k in ws:
        tol = 1e-6 + 0.2 * walk if k.endswith("mean") else 1e-6
        np.testing.assert_allclose(gs[k], ws[k], rtol=REL, atol=tol)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(state.opt_state)]
    assert [np.shape(x) for x in ts.opt_state] == [x.shape for x in jleaves]
    assert int(ts.opt_state[0]) == int(jleaves[0])
    assert int(ts.opt_state[-1]) == int(jleaves[-1])
    n = (len(jleaves) - 2) // 2
    for lo, label in ((1, "mu"), (1 + n, "nu"))[:2 if n > 0 else 0]:
        _close_leaves(ts.opt_state[lo:lo + n], jleaves[lo:lo + n], skip,
                      label)
    return ts


def _flat_stats(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_stats(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ------------------------------------------------------- (1) the train step
@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_sync_free_step_matches_css_tpu_over_six_steps(batches, optim):
    jt, state, tt, ref = _pair(optim, example=batches[0])
    skip = _vanishing(jt, state, batches[0]) if optim == "adam" else set()
    walk, clipped = 0.0, []
    for i, b in enumerate(batches):
        ref.add(b)
        state, jm = jt._train_step(state, b, jax.random.PRNGKey(0))
        tm = tt.train_step(b)
        finite = bool(jm["finite"])
        assert bool(tm["finite"]) == finite == (i != 4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=REL)
        if finite:
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=REL)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=REL)
            clipped.append(float(jm["grad_norm"]) >= THRESH)
            walk += float(tm["lr"]) if optim == "adam" else 0.0
        _compare_state(tt, state, skip, walk)
    assert clipped == [False, False, True, False, False]


# ---------------------------------------------------- (2) group dispatch
WINDOWS = [1.0, 1.0, 1.0, 1.5, 1.5, 1.5, 1.5, 1.5, 1.0, 1.0]  # 10 batches


def _epoch_batches():
    return _mixer(11, WINDOWS)


def _port_epoch(g, optim="sgd"):
    bs = _epoch_batches()
    jt, state, tt, ref = _pair(optim, example=bs[0])
    for b in bs:
        ref.add(b)
    logs = []
    loss = tt.train_one_epoch(iter([dict(b) for b in bs]), len(bs),
                              log_fn=logs.append, log_every=3,
                              steps_per_dispatch=g)
    return jt, state, tt, loss, logs, bs


def test_group_dispatch_matches_css_tpu():
    """SGD: over ten steps Adam's walk of the null-gradient parameters
    (see the tolerances) reaches the others through the network."""
    jt, state, tt, loss, logs, bs = _port_epoch(4)
    jlogs = []
    state, jloss = jt.train_one_epoch(
        state, iter([dict(b) for b in bs]), len(bs), jax.random.PRNGKey(0),
        log_fn=jlogs.append, log_every=3, steps_per_dispatch=4)
    np.testing.assert_allclose(loss, jloss, rtol=REL)
    # css_tpu logs at the last step of each group: 4, 7 (the held-over
    # shape change), 8 (a run of 1.5 s cut by the group size) and 10
    assert [r["iter"] for r in logs] == [r["iter"] for r in jlogs]
    for a, b in zip(logs, jlogs):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=REL)
    _compare_state(tt, state, set(), 0.0)


def test_group_dispatch_is_bit_equal_to_single_steps():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, _, t4, loss4, logs4, _ = _port_epoch(4)
        _, _, t1, loss1, logs1, _ = _port_epoch(1)
    finally:
        torch.set_num_threads(threads)
    assert loss4 == loss1
    s4, s1 = t4.state(), t1.state()
    assert s4.step == s1.step == len(WINDOWS)
    for a, b in zip(tree_leaves(s4.params) + tree_leaves(s4.batch_stats)
                    + s4.opt_state, tree_leaves(s1.params)
                    + tree_leaves(s1.batch_stats) + s1.opt_state):
        np.testing.assert_array_equal(a, b)
    last1 = {r["iter"]: r for r in logs1}
    for r in logs4:  # G = 4 logs where a group ends; G = 1 every 3 steps
        if r["iter"] in last1:
            assert r["loss"] == last1[r["iter"]]["loss"]


def test_stack_group_refuses_mixed_shapes():
    bs = _mixer(5, [1.0, 1.5])
    tt = Trainer(build_model("BLSTM", BLSTM_CONF), MeanSquaredError(),
                 LRSchedule(1e-3), optim="sgd", device="cpu")
    assert tt._stack_group(bs) is None
    stacked = tt._stack_group([bs[0], bs[0]])
    assert stacked["mix"].shape == (2,) + bs[0]["mix"].shape


# ------------------------------------------------------------ (3) loader
def _mixed_shapes(n=400, seed=7):
    """A single-thread producer of mixed window shapes, each batch
    numbered."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        w = int(rng.choice([8, 12, 16]))
        yield {"mix": np.full((2, w), i, np.float32)}


@pytest.mark.parametrize("group", [1, 4])
def test_loader_regroups_as_css_tpus(group):
    def draw(loader):
        out = [next(loader)["mix"] for _ in range(60)]
        loader.close()
        return [(int(m[0, 0]), m.shape[-1]) for m in out]

    got = draw(PrefetchLoader(it=_mixed_shapes(), group=group))
    want = draw(JLoader(it=_mixed_shapes(), group=group))
    assert got == want
    if group > 1:  # runs of one shape where the producer mixes them
        runs = [len(list(r)) for _, r in itertools.groupby(
            s for _, s in got)]
        assert max(runs) >= group


# ---------------------------------------------------------- (4) schedule
@pytest.mark.parametrize("sched", [
    dict(lr=1e-3, warmup=5, fixed=3, decay=0.07, min_lr=1e-5),
    dict(lr=3e-4, warmup=0, fixed=2, decay=0.013),
    dict(lr=2e-3, warmup=7, fixed=0, decay=0.5, min_lr=1e-9),
    dict(lr=1e-3),
], ids=["all", "fixed", "warmup", "flat"])
def test_device_schedule_matches_css_tpus(sched):
    j, t = jax.jit(JSchedule(**sched)), LRSchedule(**sched)
    w, f = sched.get("warmup", 0), sched.get("fixed", 0)
    counts = sorted({0, 1, max(w - 1, 0), w, w + 1, max(w + f - 1, 0),
                     w + f, w + f + 1, w + f + 2, w + f + 10, w + f + 100})
    for n in counts:
        want = np.float32(j(jnp.int32(n)))
        got = t(torch.tensor(n, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        got = np.float32(got)
        if n <= w + f or not sched.get("decay"):
            assert got == want, (n, got, want)
        else:
            assert abs(got - want) <= np.spacing(want), (n, got, want)


# --------------------------------------------------- (5) no host reads
_GUARDED = ("__bool__", "__float__", "__int__", "item", "tolist", "cpu",
            "numpy")


@contextlib.contextmanager
def no_host_reads():
    """Tensor methods that read a value back to the host raise."""
    saved = {m: getattr(torch.Tensor, m) for m in _GUARDED}

    def make(name):
        def guard(*_a, **_k):
            raise AssertionError(f"Tensor.{name} called inside a step")
        return guard

    try:
        for m in _GUARDED:
            setattr(torch.Tensor, m, make(m))
        yield
    finally:
        for m, f in saved.items():
            setattr(torch.Tensor, m, f)


@pytest.mark.parametrize("merge", [False, True], ids=["1ch", "7ch_merge"])
def test_separator_forward_reads_nothing_back(merge):
    conf = dict(CONF, idim=257 * (7 if merge else 1))
    model = build_model("Conformer", conf).eval()
    sep = Separator(model, batch_size=2, device="cpu", merge=merge,
                    ipd_index=("1,0;2,0;3,0;4,0;5,0;6,0" if merge else None))
    shape = (2, 7, sep.win) if merge else (2, sep.win)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32) * 0.1)
    with no_host_reads():
        masks, mag, kill = sep.forward(x)
    assert masks.shape[:2] == mag.shape[:2] == (2, 150)
    assert (kill is not None) == merge


@pytest.mark.parametrize("model", ["conformer", "blstm"])
def test_train_and_eval_steps_read_nothing_back(batches, model):
    jt, state, tt, ref = _pair("adam", model=model, example=batches[0])
    del tt.featurize  # the port's own features
    bs = [{k: torch.as_tensor(v) for k, v in b.items()}
          for b in batches[:2]]
    stacked = tt._stack_group(bs)
    with no_host_reads():
        tt.train_step(bs[0])
        tt.train_group(stacked)
        tt.eval_step(bs[1])
    assert tt.step == 3 and tt.updates == 3


@pytest.mark.parametrize("model", ["blstm", "conformer"])
def test_hop_step_reads_nothing_back(model):
    conf = ({**BLSTM_CONF, "blstm_causal": True} if model == "blstm" else
            {**CONF, "conformer_causal": True, "conformer_left_context": 16})
    net = build_model("BLSTM" if model == "blstm" else "Conformer", conf)
    pipe = HopStreamingPipeline(net, {"separation": {}}, chunk_frames=4,
                                device="cpu")
    frames = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (4, 512)).astype(np.float32) * 0.1)
    before = [t.clone() for t in torch.utils._pytree.tree_leaves(
        pipe._carry)]
    with no_host_reads():
        out = pipe._step(frames)
    assert out.shape == (2, 4, 512)
    after = torch.utils._pytree.tree_leaves(pipe._carry)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


def test_program_runs_its_function_directly_on_the_cpu():
    calls = []

    def fn(x, scale):
        calls.append(scale)
        return {"y": x * scale}

    prog = programs.Program(fn, "test_cpu")
    x = torch.ones(3)
    for _ in range(3):
        assert torch.equal(prog(x, 2.0)["y"], torch.full((3,), 2.0))
    assert calls == [2.0] * 3
    assert prog.summary()["captures"] == 0

