"""Port vs reference: training the ssm (mamba2-780m) and hybrid
(zamba2-7b) families on the CPU, on their smoke configs.

As ``tests/test_torch_train_families.py`` does for moe and encdec: the
reference (``repro``, JAX on the CPU, ``make_train_step`` with no mesh,
ROADMAP C-ref6) and the port (``repro_torch``, the kernels' plain
versions on the CPU: autograd of ``ref.ssd_chunked_ref`` for the SSD
scan) start from the reference's ``model.init(PRNGKey(0))`` through
``repro_torch.bridge`` and take the same numpy batches.  The batches
are 20 tokens long, so the smoke configs' chunk of 8 leaves a ragged
tail.  Tolerances: in fp32 the loss to 1e-5 relative and every
gradient leaf to 1e-5 of its largest |g|, the 3-step loss and grad-norm
trajectories to 1e-5 relative, as the dense tests; in bf16 the loss to
2e-2 relative.  bf16 gradients are held to the exact ones, the
reference's in fp32: each leaf within max(3e-2, twice the reference's
own bf16 distance from them) of its largest |g|.  zamba2's seven bf16
layers put the reference's own bf16 gradients up to 8.4e-2 of a leaf's
largest |g| from its fp32 ones (a mamba layer's dt_bias), so the dense
tests' 3e-2 between the two bf16 runs holds noise against noise there;
the port's lie up to 1.68x as far as the reference's (mamba2: 3e-2 or
less).
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
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.models.config import ShapeConfig             # noqa: E402
from repro_torch.optim.adamw import AdamW                     # noqa: E402
from repro_torch.runtime import train                         # noqa: E402
from repro_torch.tree import tree_leaves, tree_map            # noqa: E402

ARCHS = ["mamba2-780m", "zamba2-7b"]
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 3e-2)}  # (loss, grads)
SEQ = 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke model's ops are tiny: intra-op threads only contend with
    the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch, compute="float32"):
    ref_cfg = dataclasses.replace(SMOKE_ARCHS[arch], compute_dtype=compute)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute)
    ref = ref_build(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    return ref, params, build_model(cfg, device="cpu")


def _batch(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (B, SEQ)).astype(np.int32)
            for k in ("tokens", "labels")}


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


def _ref_value_and_grad(ref, params, batch, remat):
    return jax.value_and_grad(lambda p, b: ref.loss(p, b, remat=remat))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, compute, remat):
    ref, params, model = _models(arch, compute)
    batch = _batch(model.cfg)
    want_loss, want_grads = _ref_value_and_grad(ref, params, batch, remat)
    exact = want_grads
    if compute == "bfloat16":
        ref32, _, _ = _models(arch)
        exact = _ref_value_and_grad(ref32, params, batch, remat)[1]
    port = _port(params)
    for t in tree_leaves(port):
        t.requires_grad_(True)
    loss = model.loss(port, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, remat=remat)
    loss.backward()
    loss_tol, grad_tol = TOL[compute]
    assert abs(float(loss.detach()) - float(want_loss)) <= loss_tol * abs(
        float(want_loss)), ("loss", float(loss), float(want_loss))
    grads = tree_map(lambda t: t.grad, port)
    ours = {path: (ref_leaf, got)
            for path, ref_leaf, got in _by_path(want_grads, grads)}
    for path, want, _ in _by_path(exact, grads):
        ref_leaf, got = ours[path]
        scale = np.abs(want).max()
        assert scale > 0, (path, "zero reference gradient")
        # in bf16: twice the reference's own distance from the exact
        tol = max(grad_tol, 2 * np.abs(ref_leaf - want).max() / scale)
        err = np.abs(got - want).max()
        assert err <= tol * scale, (path, err / scale, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_gradients_of_no_remat_in_bits(arch):
    """Remat recomputes each layer (mamba2) or group (zamba2) on the same
    input with the same plain versions, so the gradients equal those
    without remat, bit for bit."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_trajectory_matches_reference(arch):
    ref, params, model = _models(arch)
    ref_opt, opt = RefAdamW(lr=1e-3), AdamW(lr=1e-3)
    ref_step, _ = ref_train.make_train_step(
        ref, ref_opt, RefShape("t", "train", SEQ, 4))
    ref_step = jax.jit(ref_step)
    step = train.make_train_step(model, opt,
                                 ShapeConfig("t", "train", SEQ, 4))
    ref_state = ref_train.TrainState(params, ref_opt.init(params), {})
    state = train.state_from_params(_port(params), opt)
    data = pipeline.DataPipeline(pipeline.DataConfig(
        vocab=model.cfg.vocab, seq_len=SEQ, global_batch=4))
    for k in range(3):
        batch = data.next_batch()
        ref_state, want = ref_step(ref_state, {
            n: jnp.asarray(v) for n, v in batch.items()})
        state, got = step(state, batch)
        for name in ("loss", "grad_norm"):
            assert abs(float(got[name]) - float(want[name])) <= 1e-5 * abs(
                float(want[name])), (k, name)
        assert float(got["step"]) == float(want["step"]) == k + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_on_the_cpu(capsys, tmp_path, arch):
    rc = port_cli.main(["--arch", arch, "--smoke", "--steps", "4",
                        "--batch", "8", "--seq", "32", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["device"] == "cpu"
    assert out["arch"] == f"{arch}-smoke"
    assert out["loss_drop"] > 0 and out["restarts"] == 0
