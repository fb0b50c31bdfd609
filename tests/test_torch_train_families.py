"""Port vs reference: training the moe (olmoe-1b-7b) and encdec
(whisper-small) families on the CPU.

As ``tests/test_torch_train.py`` does for the dense family: the
reference (``repro``, JAX on the CPU, ``make_train_step`` with no mesh,
ROADMAP C-ref6) and the port (``repro_torch``, the kernels' plain
versions on the CPU) start from the reference's ``model.init(PRNGKey(0))``
through ``repro_torch.bridge`` and take the same numpy batches; an
encdec batch carries ``frame_embeds`` (B, enc_seq, d_model), as the
reference's ``input_specs`` define it.  The moe loss runs both packages
at the same batch and the same dispatch groups: under capacity drops a
token's output depends on its group (ROADMAP C-ref5).  A moe mismatch
is reported with the port's smallest router gap (a token's k-th less
its (k+1)-th probability): a gap at fp32 noise is a routing tie
(C-ref3), not a port fault.

Tolerances are the dense tests': in fp32 the loss to 1e-5 relative and
every gradient leaf to 1e-5 of its largest |g|, the 3-step loss and
grad-norm trajectories to 1e-5 relative; in bf16 the loss to 2e-2
relative and every gradient leaf to 3e-2 of its largest |g|.  One kind
of leaf is held otherwise: whisper's attention key biases.  Softmax is
invariant to a shift of all of a query's scores, and with no RoPE a key
bias shifts them all by q.bk, so its gradient is exactly zero; both
packages give rounding noise (near 1e-10 in fp32, against a largest
|g| of 0.084 in the tree), so both are held to zero at the tolerance of
the tree's largest |g|.  The moe dispatch's fixed-order backward is
held against autograd of the gather it replaces, and the training CLI's
refusals are reached without a card.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.models.config import ShapeConfig as RefShape       # noqa: E402
from repro.optim.adamw import AdamW as RefAdamW               # noqa: E402
from repro.runtime import train as ref_train                  # noqa: E402
from repro_torch import bridge                                # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.data import pipeline                         # noqa: E402
from repro_torch.launch import train as port_cli              # noqa: E402
from repro_torch.models import moe                            # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.models.config import ShapeConfig             # noqa: E402
from repro_torch.optim.adamw import AdamW                     # noqa: E402
from repro_torch.runtime import train                         # noqa: E402
from repro_torch.tree import tree_leaves, tree_map            # noqa: E402

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 3e-2)}  # (loss, grads)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke model's ops are tiny: intra-op threads only contend with
    the other test workers' (several times slower under ``-n 6``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch, compute="float32", groups=1):
    """The reference model (its loss in ``groups`` dispatch groups), its
    initial parameters and the port's model."""
    ref_cfg = dataclasses.replace(SMOKE_ARCHS[arch], compute_dtype=compute)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute)
    ref = ref_build(ref_cfg, moe_groups=groups)
    params = ref.init(jax.random.PRNGKey(0))
    return ref, params, build_model(cfg, device="cpu")


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    return _with_frames(cfg, batch, rng)


def _with_frames(cfg, batch, rng):
    """An encdec batch also carries the stub frontend's frame embeddings."""
    if cfg.family == "encdec":
        B = batch["tokens"].shape[0]
        batch["frame_embeds"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _port(params):
    return bridge.params_from_reference(jax.tree.map(np.asarray, params),
                                        "cpu")


def _by_path(ref_tree, port_tree):
    """(path, reference leaf, port leaf stacked like it) in the
    reference's leaf order."""
    stacked = bridge.params_to_reference(port_tree)
    for path, a in jax.tree_util.tree_flatten_with_path(ref_tree)[0]:
        node = stacked
        for k in path:
            node = node[k.key]
        yield jax.tree_util.keystr(path), np.asarray(a, np.float32), node


def _zero_grad(cfg, path):
    """Whether the leaf at ``path`` has an exactly zero gradient: a key
    bias of an attention without RoPE (whisper's three)."""
    return cfg.family == "encdec" and path.endswith("['bk']")


def _min_gap(calls):
    """The port's smallest router gap over a forward's expert layers."""
    return min((float(c["gap"].min()) for c in calls), default=None)


# (arch, groups): olmoe in one dispatch group and in two (the reference's
# groups must then be the same); whisper has no expert layer
CASES = [("olmoe-1b-7b", 1), ("olmoe-1b-7b", 2), ("whisper-small", 1)]


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,groups", CASES)
def test_loss_and_grads_match_reference(arch, groups, compute, remat):
    ref, params, model = _models(arch, compute, groups)
    batch = _batch(model.cfg)
    kw = {"remat": remat, **({"groups": groups} if groups > 1 else {})}
    want_loss, want_grads = jax.value_and_grad(
        lambda p, b: ref.loss(p, b, remat=remat))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    port = _port(params)
    for t in tree_leaves(port):
        t.requires_grad_(True)
    with moe.record_routing() as calls:
        loss = model.loss(port, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, **kw)
        loss.backward()
    # the forward alone records: a remat recompute does not record again
    assert len(calls) == (model.cfg.n_layers if model.cfg.family == "moe"
                          else 0)
    loss_tol, grad_tol = TOL[compute]
    gap = _min_gap(calls)
    assert abs(float(loss.detach()) - float(want_loss)) <= loss_tol * abs(
        float(want_loss)), ("loss", float(loss), float(want_loss),
                            "min router gap", gap)
    grads = tree_map(lambda t: t.grad, port)
    pairs = list(_by_path(want_grads, grads))
    top = max(np.abs(want).max() for _, want, _ in pairs)
    for path, want, got in pairs:
        if _zero_grad(model.cfg, path):
            assert max(np.abs(got).max(), np.abs(want).max()) <= \
                grad_tol * top, (path, "not zero")
            continue
        err = np.abs(got - want).max()
        assert err <= grad_tol * np.abs(want).max(), (path, err,
                                                      "min router gap", gap)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "whisper-small"])
def test_remat_gives_the_gradients_of_no_remat_in_bits(arch):
    """Remat recomputes each layer with the forward's kernels (here the
    plain versions) on the same input, so it routes as the forward did
    and the gradients equal those without remat, bit for bit."""
    _, params, model = _models(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    grads = []
    for remat in (True, False):
        port = _port(params)
        for t in tree_leaves(port):
            t.requires_grad_(True)
        model.loss(port, batch, remat=remat).backward()
        grads.append([t.grad for t in tree_leaves(port)])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "whisper-small"])
def test_train_step_trajectory_matches_reference(arch):
    ref, params, model = _models(arch)
    ref_opt, opt = RefAdamW(lr=1e-3), AdamW(lr=1e-3)
    ref_step, _ = ref_train.make_train_step(
        ref, ref_opt, RefShape("t", "train", 16, 4))
    ref_step = jax.jit(ref_step)
    step = train.make_train_step(model, opt,
                                 ShapeConfig("t", "train", 16, 4))
    ref_state = ref_train.TrainState(params, ref_opt.init(params), {})
    state = train.state_from_params(_port(params), opt)
    data = pipeline.DataPipeline(pipeline.DataConfig(
        vocab=model.cfg.vocab, seq_len=16, global_batch=4))
    rng = np.random.default_rng(7)
    for k in range(3):
        batch = _with_frames(model.cfg, data.next_batch(), rng)
        ref_state, want = ref_step(ref_state, {
            n: jnp.asarray(v) for n, v in batch.items()})
        with moe.record_routing() as calls:
            state, got = step(state, batch)
        for name in ("loss", "grad_norm"):
            assert abs(float(got[name]) - float(want[name])) <= 1e-5 * abs(
                float(want[name])), (k, name, "min router gap",
                                     _min_gap(calls))
        assert float(got["step"]) == float(want["step"]) == k + 1


def _gather_dispatch(xt, slot_token):
    """The dispatch as ``moe_mlp_fwd`` wrote it before ``_Dispatch``: a
    gather from the tokens padded with a zero row, differentiated by
    autograd (a scatter-add)."""
    G, _, d = xt.shape
    xg_pad = torch.cat([xt, xt.new_zeros(G, 1, d)], dim=1)
    return torch.gather(xg_pad, 1, slot_token[..., None].expand(
        G, slot_token.shape[1], d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_backward_equals_autograd_of_the_gather(dtype):
    """``_Dispatch``'s forward is the gather; its backward, which folds a
    token's k slot gradients in dispatch order, equals autograd of the
    gather in bits (the CPU's scatter-add adds in slot order, the order
    the fold takes), with tokens dropped (capacity factor 0.5) and in two
    groups.  Exercised through ``moe_mlp_fwd`` with either dispatch."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                              capacity_factor=0.5, compute_dtype=dtype)
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe_mlp(gen, cfg, dt, "cpu")
    x = torch.randn(4, 16, cfg.d_model, generator=gen).to(dt)
    dy = torch.randn(4, 16, cfg.d_model, generator=gen).to(dt)
    results = []
    for dispatch in (moe._Dispatch.apply,
                     lambda xt, st, *_: _gather_dispatch(xt, st)):
        xx = x.clone().requires_grad_(True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(moe._Dispatch, "apply", dispatch)
            with moe.record_routing() as calls:
                y, _ = moe.moe_mlp_fwd(params, xx, cfg, groups=2)
        y.backward(dy)
        results.append((y, xx.grad))
        assert not bool(calls[0]["keep"].all())     # drops present
    (y0, g0), (y1, g1) = results
    assert torch.equal(y0, y1) and torch.equal(g0, g1)


def test_cli_trains_olmoe_on_the_cpu(capsys, tmp_path):
    rc = port_cli.main(["--arch", "olmoe-1b-7b", "--smoke", "--steps", "4",
                        "--batch", "8", "--seq", "32", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["device"] == "cpu"
    assert out["arch"] == "olmoe-1b-7b-smoke"
    assert out["loss_drop"] > 0 and out["restarts"] == 0


@pytest.mark.parametrize("arch,device,reason", [
    ("olmo-1b", "cuda", "head_dim in (64, 112, 128), got 16"),
    ("olmoe-1b-7b", "cuda", "head_dim in (64, 112, 128), got 16"),
    ("whisper-small", "cpu", "no frame_embeds"),
    ("mamba2-780m", "cuda", "P in (32, 64)"),
    ("zamba2-7b", "cuda", "head_dim in (64, 112, 128), got 16")])
def test_cli_refuses_before_the_loop(monkeypatch, capsys, tmp_path, arch,
                                     device, reason):
    """What no step could do is refused before the fault-tolerant loop,
    which would retry it forever: on the card (the device injected: the
    check reads only the config) the smoke configs' attention head_dim 16
    and, for mamba2, which runs no attention, its SSD head_dim P=16
    (zamba2's attention is refused first); encdec (no frame_embeds in
    the pipeline).  Exit code 2, the reason on stderr, no step taken."""
    monkeypatch.setattr(port_cli, "resolve_device",
                        lambda _: torch.device(device))
    monkeypatch.setattr(port_cli, "FaultTolerantLoop", None)  # never built
    rc = port_cli.main(["--arch", arch, "--smoke", "--steps", "2",
                        "--ckpt-dir", str(tmp_path)])
    err = capsys.readouterr()
    assert rc == 2 and not err.out
    assert reason in err.err and err.err.startswith("error:")
