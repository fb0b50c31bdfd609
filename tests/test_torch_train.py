"""Port vs reference: single-device dense training on the CPU.

The reference (``repro``, JAX on the CPU, no mesh: ``make_train_step``
of ``repro.runtime.train`` without shardings) and the port
(``repro_torch``, the kernels' plain versions on the CPU) start from the
same parameters, the reference's ``model.init(PRNGKey(0))`` through
``repro_torch.bridge``, and take the same numpy batches.

Tolerances: in fp32 compute the loss to 1e-5 relative and every
gradient leaf to 1e-5 of its largest |g|; AdamW's update to 1e-6; the
3-step loss and grad-norm trajectories to 1e-5 relative.  In bf16
compute the loss to 2e-2 relative and every gradient leaf to 3e-2 of its
largest |g|: bf16 rounds at other places in the two frameworks, and on
these inputs the reference's own bf16 gradients lie up to 2.4e-2 of the
largest |g| from its fp32 gradients (the port's up to 2.2e-2), so two
bf16 gradients may differ by about that much.  Data batches, the
fault-tolerant loop's recovery and the optimizer offload are held in
bits.
"""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.data import pipeline as ref_pipeline               # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.models.config import ShapeConfig as RefShape       # noqa: E402
from repro.optim.adamw import AdamW as RefAdamW               # noqa: E402
from repro.runtime import ft as ref_ft                        # noqa: E402
from repro.runtime import train as ref_train                  # noqa: E402
from repro_torch import bridge                                # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt               # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.core.tiering import TieringPolicy            # noqa: E402
from repro_torch.data import pipeline                         # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.models.config import ShapeConfig             # noqa: E402
from repro_torch.optim.adamw import AdamW, AdamWState         # noqa: E402
from repro_torch.runtime import ft                            # noqa: E402
from repro_torch.runtime import train                         # noqa: E402
from repro_torch.tree import tree_leaves, tree_map            # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 3e-2)}  # (loss, grads)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke model's ops are tiny: intra-op threads only contend with
    the other test workers' (several times slower under ``-n 6``)."""
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


def _batch(vocab, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


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


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen1.5-0.5b"])
def test_loss_and_grads_match_reference(arch, compute, remat):
    ref, params, model = _models(arch, compute)
    batch = _batch(model.cfg.vocab)
    want_loss, want_grads = jax.value_and_grad(
        lambda p, b: ref.loss(p, b, remat=remat))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    port = _port(params)
    for t in tree_leaves(port):
        t.requires_grad_(True)
    loss = model.loss(port, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, remat=remat)
    loss.backward()
    loss_tol, grad_tol = TOL[compute]
    assert abs(float(loss.detach()) - float(want_loss)) <= loss_tol * abs(
        float(want_loss))
    grads = tree_map(lambda t: t.grad, port)
    for path, want, got in _by_path(want_grads, grads):
        err = np.abs(got - want).max()
        assert err <= grad_tol * np.abs(want).max(), (path, err)


def test_masked_loss_matches_reference():
    from repro.models import layers as ref_layers
    from repro_torch.models import layers
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = ref_layers.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = layers.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        assert abs(float(got) - float(want)) <= 1e-6 * max(1, abs(float(want)))


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])   # clip off / on
def test_adamw_update_matches_reference(grad_scale):
    _, params, _ = _models("qwen1.5-0.5b")
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda p: (grad_scale * rng.standard_normal(
        p.shape)).astype(np.float32), params)
    ref_opt, opt = RefAdamW(lr=1e-2), AdamW(lr=1e-2)
    ref_state, ref_params = ref_opt.init(params), params
    state, port = opt.init(_port(params)), _port(params)
    for _ in range(3):   # three updates: the bias corrections move
        ref_params, ref_state, ref_norm = ref_opt.update(
            grads, ref_state, ref_params)
        port, state, norm = opt.update(_port(grads), state, port)
        assert abs(float(norm) - float(ref_norm)) <= 1e-6 * float(ref_norm)
    assert int(state.step) == int(ref_state.step) == 3
    for ref_tree, tree in ((ref_params, port), (ref_state.mu, state.mu),
                           (ref_state.nu, state.nu)):
        for path, want, got in _by_path(ref_tree, tree):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=path)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_trajectory_matches_reference(microbatches):
    ref, params, model = _models("olmo-1b")
    ref_opt, opt = RefAdamW(lr=1e-3), AdamW(lr=1e-3)
    ref_step, _ = ref_train.make_train_step(
        ref, ref_opt, RefShape("t", "train", 16, 4, microbatches),
        tcfg=ref_train.TrainStepConfig(microbatches=microbatches))
    ref_step = jax.jit(ref_step)
    tcfg = train.TrainStepConfig(microbatches=microbatches)
    step = train.make_train_step(
        model, opt, ShapeConfig("t", "train", 16, 4, microbatches), tcfg=tcfg)
    ref_state = ref_train.TrainState(params, ref_opt.init(params), {})
    state = train.state_from_params(_port(params), opt, tcfg)
    data = pipeline.DataPipeline(pipeline.DataConfig(
        vocab=model.cfg.vocab, seq_len=16, global_batch=4))
    for k in range(3):
        batch = data.next_batch()
        ref_state, want = ref_step(ref_state, {
            n: jnp.asarray(v) for n, v in batch.items()})
        state, got = step(state, batch)
        for name in ("loss", "grad_norm"):
            assert abs(float(got[name]) - float(want[name])) <= 1e-5 * abs(
                float(want[name])), (k, name)
        assert float(got["step"]) == float(want["step"]) == k + 1


def test_data_batches_equal_the_reference():
    for seed, hosts in ((0, 1), (3, 2)):
        kw = dict(vocab=1000, seq_len=33, global_batch=4, seed=seed,
                  n_hosts=hosts, host_id=hosts - 1)
        ref = ref_pipeline.DataPipeline(ref_pipeline.DataConfig(**kw))
        port = pipeline.DataPipeline(pipeline.DataConfig(**kw)).start()
        for _ in range(4):
            want, got = ref.next_batch(), port.get()
            assert want.keys() == got.keys()
            for k in want:
                assert want[k].dtype == got[k].dtype
                assert (want[k] == got[k]).all()
        port.stop()
        assert port.state.to_dict() == ref.state.to_dict()


def _olmo_loop_parts(model):
    """A jit-free step and a data pipeline of the olmo smoke model."""
    opt = AdamW(lr=1e-3)
    step = train.make_train_step(model, opt,
                                 ShapeConfig("t", "train", 16, 4))
    data = pipeline.DataPipeline(pipeline.DataConfig(
        vocab=model.cfg.vocab, seq_len=16, global_batch=4))
    return opt, step, data


def test_fault_tolerant_loop_recovers_from_its_checkpoint(tmp_path):
    """An injected failure at step 5 outlasts the retries; the loop
    restores the step-4 checkpoint the port's ``ckpt.save`` wrote and
    converges to the failure-free run's state in bits."""
    _, params, model = _models("olmo-1b")

    def run(with_failure: bool):
        opt, step, data = _olmo_loop_parts(model)
        state = train.state_from_params(_port(params), opt)
        path = tmp_path / f"run{int(with_failure)}"
        saved = {}

        def save_fn(s, k):
            # one directory per step, as the training CLI's: an async
            # save may still be writing the last one
            saved["path"] = path / f"step{k}"
            saved["handle"] = ckpt.save(
                saved["path"],
                {"params": s.params, "mu": s.opt.mu, "nu": s.opt.nu},
                step=k, asynchronous=True)

        def restore_fn():
            saved["handle"].wait()
            tree, meta = ckpt.restore(saved["path"], {
                "params": state.params, "mu": state.opt.mu,
                "nu": state.opt.nu})
            k = meta["step"]
            return train.TrainState(tree["params"], AdamWState(
                torch.tensor(k, dtype=torch.int32), tree["mu"], tree["nu"]),
                {}), k

        failures = {"left": 3 if with_failure else 0}

        def failure_hook(k):
            if k == 5 and failures["left"]:
                failures["left"] -= 1
                raise RuntimeError("injected chip failure")

        loop = ft.FaultTolerantLoop(
            step, save_fn, restore_fn, data, ckpt_every=4,
            retry=ft.RetryPolicy(max_retries=1, backoff_s=0.0),
            failure_hook=failure_hook)
        return loop.run(state, 7), loop

    clean, clean_loop = run(False)
    recovered, loop = run(True)
    assert (clean_loop.restarts, loop.restarts) == (0, 1)
    # history steps are the optimizer's count after each step
    assert [h["step"] for h in loop.history] == [1, 2, 3, 4, 5, 5, 6, 7]
    for a, b in zip(tree_leaves(clean), tree_leaves(recovered)):
        assert torch.equal(a, b)


def test_straggler_monitor_and_retry_match_the_reference():
    times = [1.0, 1.0, 1.1, 5.0, 1.0, 9.0, 1.2, 30.0, 1.0]
    ref_m, m = ref_ft.StragglerMonitor(), ft.StragglerMonitor()
    assert ([ref_m.observe(k, t) for k, t in enumerate(times)]
            == [m.observe(k, t) for k, t in enumerate(times)])
    assert ref_m.events == m.events and ref_m.ewma == m.ewma
    assert ref_m.recommendation() == m.recommendation()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert ft.RetryPolicy(max_retries=2, backoff_s=0.0).run(flaky) == "ok"
    with pytest.raises(OSError):
        ft.RetryPolicy(max_retries=0, backoff_s=0.0).run(
            lambda: (_ for _ in ()).throw(OSError("down")))


@pytest.mark.parametrize("masters", [False, True])
def test_offload_optimizer_gives_the_in_place_bits(masters):
    """``offload_optimizer`` (and ``offload_master_params``) keep the
    moments (and the fp32 masters) in tier 2 (host memory; on the CPU
    that is where they already are) and copy them through each step: the
    same bits as the step without it."""
    _, params, model = _models("qwen1.5-0.5b")
    data = pipeline.DataPipeline(pipeline.DataConfig(
        vocab=model.cfg.vocab, seq_len=16, global_batch=4))
    batches = [data.next_batch() for _ in range(2)]
    results = []
    for policy in (None, TieringPolicy(offload_optimizer=True,
                                       offload_master_params=masters)):
        opt = AdamW(lr=1e-3)
        step = train.make_train_step(model, opt,
                                     ShapeConfig("t", "train", 16, 4),
                                     tiering=policy)
        state = train.state_from_params(_port(params), opt, tiering=policy)
        for b in batches:
            state, _ = step(state, b)
        results.append(state)
    for a, b in zip(tree_leaves(results[0]), tree_leaves(results[1])):
        assert torch.equal(a, b)


def test_adamw_moves_the_moments_a_leaf_at_a_time():
    """``fetch`` and ``stash`` (the tier-2 offload's hooks) see each leaf's
    two moments in turn, the next leaf's fetched only after this one's
    are stashed, and leave the update's bits as they are."""
    _, params, _ = _models("qwen1.5-0.5b")
    rng = np.random.default_rng(5)
    grads = _port(jax.tree.map(lambda p: rng.standard_normal(
        p.shape).astype(np.float32), params))
    opt = AdamW(lr=1e-2)
    state = opt.init(_port(params))
    calls = []

    def fetch(t):
        calls.append("fetch")
        return t.clone()

    def stash(t):
        calls.append("stash")
        return t.clone()

    plain = opt.update(grads, state, _port(params))
    hooked = opt.update(grads, state, _port(params), fetch=fetch,
                        stash=stash)
    n = len(tree_leaves(state.mu))
    assert calls == ["fetch", "fetch", "stash", "stash"] * n
    for a, b in zip(tree_leaves(plain), tree_leaves(hooked)):
        assert torch.equal(a, b)


def test_hierarchical_dp_mode_waits_for_the_distributed_slice():
    """Without a rank grid there is no ``pod`` axis to reduce over: the
    reference's error (the grid's step is held against the reference in
    ``tests/test_torch_train_dist.py``)."""
    model = build_model(get_config("olmo-1b", smoke=True), device="cpu")
    with pytest.raises(ValueError, match="'pod' axis"):
        train.make_train_step(model, AdamW(), ShapeConfig("t", "train", 8, 2),
                              tcfg=train.TrainStepConfig(
                                  dp_mode="hierarchical"))


def _reference_cli_keys():
    """The keys of the JSON dict the reference's training CLI emits."""
    tree = ast.parse((ROOT / "src/repro/launch/train.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "")
                == "emit_json"):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no emit_json call in the reference CLI")


@pytest.mark.parametrize("extra", [[], ["--offload-optimizer",
                                        "--microbatches", "2"],
                                   ["--pool", "scalepool",
                                    "--pool-tier2-gb", "8",
                                    "--dp-mode", "hierarchical"]])
def test_cli_trains_on_the_cpu_when_asked(capsys, tmp_path, extra):
    from repro_torch.launch.train import main
    rc = main(["--smoke", "--steps", "4", "--batch", "8", "--seq", "32",
               "--device", "cpu", "--ckpt-dir", str(tmp_path)] + extra)
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["device"] == "cpu"
    assert list(out) == _reference_cli_keys() + ["device"]
    assert out["loss_drop"] > 0 and out["restarts"] == 0
    if "--pool" in extra:
        assert out["lease"]["offload_optimizer"] and out["dp_mode"] == "auto"


@pytest.mark.parametrize("layers", [1, 2])
def test_cli_layers_trains_the_first_layers(capsys, tmp_path, monkeypatch,
                                            layers):
    from repro_torch.launch import train as cli
    built = []
    real = cli.build_model
    monkeypatch.setattr(cli, "build_model",
                        lambda cfg, **kw: built.append(cfg) or real(cfg, **kw))
    rc = cli.main(["--smoke", "--layers", str(layers), "--steps", "2",
                   "--batch", "8", "--seq", "32", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out)
    full = get_config("olmo-1b", smoke=True)
    assert rc == 0 and out["device"] == "cpu"
    assert [c.n_layers for c in built] == [layers]
    assert built[0] == dataclasses.replace(full, n_layers=layers)


def test_cli_layers_refuses_more_than_the_config_has(tmp_path):
    from repro_torch.launch.train import main
    n = get_config("olmo-1b", smoke=True).n_layers
    with pytest.raises(SystemExit) as e:
        main(["--smoke", "--layers", str(n + 1), "--device", "cpu",
              "--ckpt-dir", str(tmp_path)])
    assert e.value.code == 2
