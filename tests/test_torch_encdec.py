"""Port vs reference: the encdec family (whisper-small smoke) on the CPU.

The reference's ``model.init(PRNGKey(0))`` weights go through
``repro_torch.bridge``; the same numpy frame embeddings and prompts go
through ``repro.models`` (JAX on the CPU) and ``repro_torch.models`` (the
kernels' plain versions on the CPU).  ``encode``, ``prefill`` (logits,
decoder cache, encoder states) and ``decode_step`` must agree within 1e-5
in fp32 and 2e-2 in bf16.  In bf16 the logits are held against the
reference as it runs and, with the encoder states and the cache, against
the reference run op by op (``jax.disable_jit``): compiled, XLA keeps
fused chains of bf16 ops in fp32 (ROADMAP C-port4), which moves the
encoder states by a few bf16 ulps.  Greedy tokens of an 8-step
generation through ``make_decode_step`` must be identical in fp32, and
the CLI's fixed-batch mode on the reference CLI's weights, prompts and
frames gives the reference fixed-batch mode's tokens."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import SMOKE_ARCHS                         # noqa: E402
from repro.models import encdec as ref_encdec                 # noqa: E402
from repro.models.api import build_model as ref_build         # noqa: E402
from repro.runtime import serve as ref_serve                  # noqa: E402
from repro_torch import bridge, kernels                       # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.launch import serve as port_cli              # noqa: E402
from repro_torch.models import encdec                         # noqa: E402
from repro_torch.models.api import build_model                # noqa: E402
from repro_torch.runtime import serve as port_serve           # noqa: E402

ARCH = "whisper-small"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S = 2, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke model's ops are tiny: intra-op threads only contend with
    the other test workers' (several times slower under ``-n 6``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(compute):
    ref_cfg = dataclasses.replace(SMOKE_ARCHS[ARCH], compute_dtype=compute)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype=compute)
    ref = ref_build(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    port = build_model(cfg, device="cpu")
    params = port.load(bridge.params_from_reference(
        jax.tree.map(np.asarray, ref_params), device="cpu"))
    return ref, ref_params, port, params


def _inputs(cfg, seed=0):
    rs = np.random.RandomState(seed)
    frames = jnp.asarray(rs.randn(B, cfg.enc_seq, cfg.d_model).astype(
        np.float32)).astype(jnp.bfloat16)
    tokens = rs.randint(1, cfg.vocab, size=(B, S)).astype(np.int32)
    return frames, tokens


def _t(x):
    return bridge.to_tensor(np.asarray(x), "cpu")


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_encode_matches_reference(compute):
    ref, ref_params, port, params = _models(compute)
    frames, _ = _inputs(port.cfg)
    cast = ref_encdec.T.cast_params(ref_params, ref.cfg)

    def ref_encode():
        return ref_encdec.encode(cast, ref.cfg, frames)

    kernels.reset_launch_counts()
    got = encdec.encode(params, port.cfg, _t(frames))
    assert tuple(got.shape) == (B, port.cfg.enc_seq, port.cfg.d_model)
    assert got.dtype == encdec.T.dtype_of(compute)
    assert sum(kernels.launch_counts().values()) == 0   # CPU: plain only
    if compute == "bfloat16":
        with jax.disable_jit():
            want = ref_encode()
    else:
        want = jax.jit(ref_encode)()
    _close(got, want, TOL[compute], "encoder states")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_prefill_and_decode_step_match_reference(compute):
    ref, ref_params, port, params = _models(compute)
    frames, tokens = _inputs(port.cfg, seed=1)

    def ref_prefill():
        return ref.prefill(ref_params, {"frame_embeds": frames,
                                        "tokens": jnp.asarray(tokens)},
                           ref.init_cache(B, S + 4, dtype=jnp.float32))

    want, want_cache, want_enc = ref_prefill()
    got, cache, enc = port.prefill(
        params, {"frame_embeds": _t(frames),
                 "tokens": torch.as_tensor(tokens, dtype=torch.long)},
        port.init_cache(B, S + 4, dtype=torch.float32))
    assert tuple(got.shape) == (B, 1, port.cfg.vocab)
    _close(got, want, TOL[compute], "prefill logits")
    if compute == "bfloat16":
        with jax.disable_jit():
            want, want_cache, want_enc = ref_prefill()
        _close(got, want, TOL[compute], "prefill logits, op by op")
    _close(enc, want_enc, TOL[compute], "encoder states")
    for name in ("k", "v"):
        _close(cache[name], want_cache[name], TOL[compute],
               f"prefill cache {name}")

    # one decode step from the reference's own cache and encoder states
    nxt = np.asarray([[3], [port.cfg.vocab - 1]], np.int32)

    def ref_decode():
        return ref.decode(ref_params, jnp.asarray(nxt), want_cache,
                          jnp.int32(S), want_enc)

    want, want_cache2 = ref_decode()
    got, cache2 = port.decode(
        params, torch.as_tensor(nxt, dtype=torch.long),
        bridge.pool_from_reference(jax.tree.map(np.asarray, want_cache),
                                   device="cpu"), S, _t(want_enc))
    assert tuple(got.shape) == (B, 1, port.cfg.vocab)
    _close(got, want, TOL[compute], "decode logits")
    if compute == "bfloat16":
        with jax.disable_jit():
            want, want_cache2 = ref_decode()
        _close(got, want, TOL[compute], "decode logits, op by op")
    for name in ("k", "v"):
        _close(cache2[name], want_cache2[name], TOL[compute],
               f"decode cache {name}")


def test_greedy_generation_tokens_identical():
    """Prefill, then 8 greedy steps through each package's
    ``make_decode_step`` (the carry holds the encoder states): tokens
    identical in fp32."""
    ref, ref_params, port, params = _models("float32")
    frames, tokens = _inputs(port.cfg, seed=2)
    steps = 8
    logits, cache, enc = jax.jit(ref_serve.make_prefill_step(ref))(
        ref_params, {"frame_embeds": frames, "tokens": jnp.asarray(tokens)},
        ref.init_cache(B, S + steps + 1, dtype=jnp.float32))
    carry = {"tokens": jnp.argmax(logits[:, -1:], -1).astype(jnp.int32),
             "cache": cache, "index": jnp.int32(S), "enc_states": enc}
    decode = jax.jit(ref_serve.make_decode_step(ref))
    want, want_logits = [np.asarray(carry["tokens"])], []
    for _ in range(steps):
        lg, carry = decode(ref_params, carry)
        want_logits.append(np.asarray(lg[:, -1]))
        want.append(np.asarray(carry["tokens"]))

    plog, pcache, penc = port_serve.make_prefill_step(port)(
        params, {"frame_embeds": _t(frames),
                 "tokens": torch.as_tensor(tokens, dtype=torch.long)},
        port.init_cache(B, S + steps + 1, dtype=torch.float32))
    pc = {"tokens": torch.argmax(plog[:, -1:], -1), "cache": pcache,
          "index": S, "enc_states": penc}
    step = port_serve.make_decode_step(port)
    got = [pc["tokens"].numpy()]
    for _ in range(steps):
        _, pc = step(params, pc)
        got.append(pc["tokens"].numpy())
    assert pc["index"] == S + steps and pc["enc_states"] is penc
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w):
            lg = want_logits[i - 1] if i else np.asarray(logits[:, -1])
            top2 = np.sort(lg, axis=-1)[:, -2:]
            pytest.fail(f"greedy tokens diverge at step {i}: port "
                        f"{g.ravel()} vs reference {w.ravel()}; reference "
                        f"top-2 logit margins "
                        f"{(top2[:, 1] - top2[:, 0]).tolist()}")


def test_sinusoidal_matches_reference():
    """The position table: the frequencies ``exp(-log(1e4) i / (half-1))``
    differ from XLA's in the last bit now and then (its exp is not
    torch's), and the rounded angle ``pos * freq`` then moves by up to
    an ulp of itself: at encoder positions up to 1500 (angles up to 1500
    rad, ulp 2^-13) an entry may move by two such ulps, 1500 * 2^-22;
    at the decoder's positions (< 64) by less than 1e-5."""
    for d in (64, 768):
        for hi, tol in ((64, 1e-5), (1500, 1500 * 2.0 ** -22)):
            pos = np.arange(hi)
            _close(encdec._sinusoidal(torch.as_tensor(pos), d),
                   ref_encdec._sinusoidal(jnp.asarray(pos), d), tol,
                   f"sinusoidal d={d} positions < {hi}")


def test_bridge_unstacks_encoder_and_decoder_layers():
    ref, ref_params, port, _ = _models("float32")
    tree = jax.tree.map(np.asarray, ref_params)
    params = bridge.params_from_reference(tree, device="cpu")
    cfg = port.cfg
    assert len(params["enc_layers"]) == cfg.n_enc_layers
    assert len(params["dec_layers"]) == cfg.n_layers
    for i, layer in enumerate(params["dec_layers"]):
        np.testing.assert_array_equal(
            layer["cross_attn"]["wk"].numpy(),
            tree["dec_layers"]["cross_attn"]["wk"][i])
    np.testing.assert_array_equal(params["enc_norm"]["scale"].numpy(),
                                  tree["enc_norm"]["scale"])
    drawn = port.init(torch.Generator().manual_seed(0))
    assert drawn.keys() == params.keys()
    for name in ("enc_layers", "dec_layers"):
        assert [{k: tuple(t.shape) for k, t in _flat(layer)}
                for layer in drawn[name]] == \
            [{k: tuple(t.shape) for k, t in _flat(layer)}
             for layer in params[name]]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# the CLI's fixed-batch mode against the reference CLI
# ---------------------------------------------------------------------------

BATCH_ARGS = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt", "8",
              "--generate", "6"]


def _reference_cli_batch(batch, prompt, generate):
    """``repro.launch.serve``'s fixed-batch mode (``_legacy_batch_mode``,
    ``src/repro/launch/serve.py:270-312``) as it computes: weights,
    prompts and frames from ``PRNGKey(0)``, prefill over an fp32 cache,
    jitted greedy decode steps.  The CLI itself stops at its smoke
    mesh's sharding rules under this JAX (ROADMAP C-ref1), so the loop
    is run here without them (one device: nothing to shard)."""
    cfg = SMOKE_ARCHS[ARCH]
    model = ref_build(cfg)
    rng = jax.random.PRNGKey(0)
    params = model.init(rng)
    prompts = jax.random.randint(rng, (batch, prompt), 1, cfg.vocab)
    frames = jax.random.normal(rng, (batch, cfg.enc_seq, cfg.d_model),
                               jnp.bfloat16)
    cache = model.init_cache(batch, prompt + generate, dtype=jnp.float32)
    logits, cache, enc = model.prefill(
        params, {"frame_embeds": frames, "tokens": prompts}, cache)
    carry = {"tokens": jnp.argmax(logits[:, -1:, :], -1).astype(jnp.int32),
             "cache": cache, "index": jnp.int32(prompt), "enc_states": enc}
    decode = jax.jit(ref_serve.make_decode_step(model))
    generated = [np.asarray(carry["tokens"])]
    for _ in range(generate - 1):
        _, carry = decode(params, carry)
        generated.append(np.asarray(carry["tokens"]))
    toks = np.concatenate(generated, axis=1)
    out = {"arch": cfg.name, "mode": "batch", "batch": batch,
           "prompt": prompt, "generated": toks.shape[1],
           "sample_tokens": toks[0, :8].tolist()}
    return out, (params, prompts, frames)


def test_cli_fixed_batch_mode_matches_reference(capsys, monkeypatch):
    """``repro_torch.launch.serve`` on whisper smoke, on the CPU, fed the
    reference CLI's draw (weights, prompts and frame embeddings from
    ``PRNGKey(0)``): the reference fixed-batch mode's sample tokens and
    fields, plus ``device``; the port's own draw has the reference's
    shapes and dtypes."""
    want, (ref_params, prompts, frames) = _reference_cli_batch(2, 8, 6)
    drawn, own_draw = {}, port_cli.fixed_batch_inputs

    def inputs(model, batch, prompt, seed, device):
        drawn["own"] = own_draw(model, batch, prompt, seed, device)
        return (bridge.params_from_reference(
            jax.tree.map(np.asarray, ref_params), device="cpu"),
            {"tokens": torch.as_tensor(np.array(prompts), dtype=torch.long),
             "frame_embeds": _t(frames)})

    monkeypatch.setattr(port_cli, "fixed_batch_inputs", inputs)
    rc = port_cli.main(["--arch", ARCH, "--smoke", "--batch", "2",
                        "--prompt", "8", "--generate", "6", "--device",
                        "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out.pop("device") == "cpu"
    out.pop("prefill_s"), out.pop("decode_tok_per_s")
    assert out == want
    raw, own = drawn["own"]
    cfg = SMOKE_ARCHS[ARCH]
    assert tuple(own["frame_embeds"].shape) == (2, cfg.enc_seq, cfg.d_model)
    assert own["frame_embeds"].dtype == torch.bfloat16
    assert tuple(own["tokens"].shape) == (2, 8)
    assert raw.keys() == ref_params.keys()
