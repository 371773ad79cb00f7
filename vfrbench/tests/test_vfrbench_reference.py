"""Each reference against the port at tiny sizes on the CPU, the control
against its limits, and the faults a run can have against ``correct``.

The cells' own limits are set on the card at their sizes; here the tiny
cells carry limits of 1e-5, which the port meets on the CPU (its plain
versions do the reference's arithmetic) and the control, one precision
lower, does not."""

import time

import pytest
import torch

from vfrbench import catalog, run
from vfrbench.reference import judge, mcn
from vfrbench.tests import _tiny
from vfrbench.trace import Tracer

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(str(tmp_path_factory.mktemp("tiny") / "root"))


def _checked(root, name, seed, **kw):
    cell = catalog.cell(name, root)
    drv = catalog.load_module("drivers", cell.driver, root)
    st = drv.setup(cell, catalog.experiment(cell.config), seed, 0.3, CPU)
    drv.window(st, 0.3, Tracer(False, 0.3))
    drv.release(st)
    return cell, drv.check(st, **kw)


SERVING = sorted(n for n in _tiny.CELLS if not n.endswith("-train"))


@pytest.mark.parametrize("name", sorted(_tiny.CELLS))
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_port_meets_the_reference(root, name, seed):
    cell, r = _checked(root, name, seed)
    ok, rows = judge.verdict(r, cell.limits)
    assert ok, rows


@pytest.mark.parametrize("name", sorted(_tiny.CELLS))
def test_control_fails(root, name):
    """The reference one precision lower in the port's place fails a
    number, on three seeds."""
    for seed in (5, 6, 7):
        cell, r = _checked(root, name, seed, control=True)
        ok, rows = judge.verdict(r, cell.limits)
        assert not ok, rows


@pytest.mark.parametrize("stage", mcn.QUERY_STAGES + ("score",))
@pytest.mark.parametrize("name", SERVING)
def test_stage_control_fails(root, name, stage):
    """One stage alone one precision lower, the rest as stated:
    ``lower_share`` reads that precision's rounding."""
    for seed in (5, 6, 7):
        cell, r = _checked(root, name, seed, control={stage})
        ok, rows = judge.verdict(r, cell.limits)
        assert not ok and r["lower_share"] > 0.5, rows


@pytest.mark.parametrize("fault", mcn.SELECT_FAULTS)
@pytest.mark.parametrize("name", SERVING)
def test_select_fault_fails(root, name, fault):
    """The reference at the stated precisions with a planted select fault
    in the port's place: ``rank_gap`` fails."""
    for seed in (5, 6, 7):
        cell, r = _checked(root, name, seed, fault=fault)
        ok, rows = judge.verdict(r, cell.limits)
        assert not ok and r["rank_gap"] > cell.limits["rank_gap"], rows
        if fault == "offbyone":
            assert r["set_gap"] > cell.limits["set_gap"], rows


def test_shared_rows():
    rows = torch.tensor([[0, 1], [1, 2], [3, 4]])
    # one pair of the 3 * 2 ordered pairs shares 1 row of 2
    assert judge.shared_rows(rows, 5) == pytest.approx(2 / (3 * 2 * 2))


def test_rounding_steps():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10 + 2 ** -12, 3.14159])
    assert mcn.round_to(x, "float32") is x
    t = mcn.round_to(x, "tf32")
    assert t[0] == 1.0 and t[1] == 1.0 + 2 ** -10
    assert abs(float(t[2]) - 3.14159) < 2 ** -10 * 4
    assert mcn.lower({"a": "float32", "b": "bfloat16"}) == {
        "a": "tf32", "b": "float8"}


def test_train_reference_follows_its_own_autograd():
    """The reference's first gradient is the derivative of its loss: a
    finite difference along the gradient agrees with its squared norm."""
    torch.manual_seed(0)
    spec = {"layers": 1, "query_pool": "mean", "stream_names": ("rgb",),
            "stream_weights": (1.0,), "per_stream_proj": False,
            "global_context": True, "tef": True, "distance": "cosine",
            "temperature": 0.05, "lambda_intra": 1.0, "lambda_inter": 1.0,
            **mcn.spec_tables(3, "cpu")}
    E, H, d, F, V, B = 4, 6, 5, 7, 9, 4
    p = {"embeddings": torch.randn(20, E).double(),
         "lstm": {"layer0": {"w_ih": torch.randn(E, 4 * H).double() * .3,
                             "w_hh": torch.randn(H, 4 * H).double() * .3,
                             "b": torch.zeros(4 * H).double()}},
         "query_proj": {"w": torch.randn(H, d).double(),
                        "b": torch.zeros(d).double()},
         "moment_proj_rgb": {"w": torch.randn(2 * F + 2, d).double(),
                             "b": torch.zeros(d).double()}}
    spec["pool"], spec["tef_table"] = (spec["pool"].double(),
                                       spec["tef_table"].double())
    banks = {"rgb": torch.randn(V, 3, F).double()}
    batch = {"tokens": torch.randint(2, 20, (B, 5)),
             "lengths": torch.tensor([5, 2, 3, 1]),
             "target": torch.randint(0, 6, (B,)),
             "video_idx": torch.tensor([0, 1, 1, 2]),
             "hard_neg_video": torch.randint(3, V, (B, 2)),
             "hard_neg_prop": torch.randint(0, 6, (B, 2))}
    plan = {"all": "float32"}
    w = p["query_proj"]["w"].requires_grad_(True)
    loss = mcn.infonce_loss(p, spec, batch, banks, plan)
    (g,) = torch.autograd.grad(loss, [w])
    eps = 1e-6
    with torch.no_grad():
        up = mcn.infonce_loss({**p, "query_proj": {"w": w + eps * g,
                                                   "b": p["query_proj"]["b"]}},
                              spec, batch, banks, plan)
    slope = float((up - loss.detach()) / eps)
    assert slope == pytest.approx(float((g * g).sum()), rel=1e-3)


# ---------------------------------------------------------------- faults

def _run(root, name):
    return run.run_cell(catalog.cell(name, root), 8, 0.3, False, CPU,
                        time.perf_counter(), root=root)


def test_fault_answer_altered(root, monkeypatch):
    """A row changed where the retriever produces it."""
    import vfr_tpu_torch.eval.corpus as corpus

    real = corpus.make_retriever

    def broken(*a, **kw):
        fn = real(*a, **kw)

        def retrieve(*args):
            d, r = fn(*args)
            r = r.clone()
            r[0, 0] = (r[0, 0] + 1) % (a[1].num_rows)
            return d, r
        return retrieve

    monkeypatch.setattr(corpus, "make_retriever", broken)
    for name in ("tiny-flagship-batch", "tiny-flagship-daemon",
                 "tiny-s10k-batch"):
        line = _run(root, name)
        assert line["correct"] is False, (name, line["checks"])


def test_fault_half_batch_left_out(root, monkeypatch):
    """The step sees half of its batch: its loss is the mean over the
    rest."""
    import vfr_tpu_torch.train.step as step

    real = step.make_train_step

    def broken(*a, **kw):
        fn = real(*a, **kw)

        def half(params, opt_state, batch, ema=None):
            n = batch["tokens"].shape[0] // 2
            return fn(params, opt_state, {k: v[:n] for k, v in batch.items()},
                      ema)
        return half

    monkeypatch.setattr(step, "make_train_step", broken)
    line = _run(root, "tiny-flagship-train")
    assert line["correct"] is False
    assert line["checks"]["loss_gap"]["value"] > 1e-3


def test_fault_state_unchanged(root, monkeypatch):
    """The step returns its state unchanged."""
    import vfr_tpu_torch.train.step as step

    real = step.make_train_step

    def broken(*a, **kw):
        fn = real(*a, **kw)

        def frozen(params, opt_state, batch, ema=None):
            _, s, _, aux = fn(params, opt_state, batch, ema)
            return params, s, ema, aux
        return frozen

    monkeypatch.setattr(step, "make_train_step", broken)
    line = _run(root, "tiny-flagship-train")
    assert line["correct"] is False
    assert line["checks"]["step_gap"]["value"] == pytest.approx(1.0)
