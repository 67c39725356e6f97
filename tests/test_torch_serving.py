"""Port parity for the RAG serving path: `repro_torch.serving` against the
JAX package's `repro.serving` on one memory state carried across with
`ivf_state_from_numpy` and the reference's parameters carried across with
`lm_params_from_numpy`, at reduced sizes (granite-3-2b, and one arch of
each of the MoE, VLM, SSM and hybrid families); then the port's entry
points (`python -m repro_torch.launch.serve`, `python -m
repro_torch.serve_agent`) on the CPU.

The reference's scan runs as its own tests run it (Pallas in interpret
mode); the port's runs its plain version on the CPU.  Tolerances: float32
logits, caches and retrieval scores to rtol = atol = 1e-4; the retrieved
ids equal, with the test asserting that the k-th score clears the next by
more than that tolerance; bfloat16 logits within 1e-2 of their largest
magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import EngineConfig as JConfig
from repro.core import index as jivf
from repro.models import api as japi
from repro.models import lm as jlm
from repro.serving import rag as jrag
from repro.serving import serve_step as jserve
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import EngineConfig
from repro_torch.core import index as ivf
from repro_torch.launch import serve
from repro_torch.models import api, lm
from repro_torch.serving import rag, serve_step

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-4
ROWS = 500
K = 4


def _ecfgs(dim):
    kw = dict(dim=dim, n_clusters=128, list_capacity=16, nprobe=8, k=K,
              kmeans_iters=2)
    return JConfig(interpret=True, **kw), EngineConfig(**kw)


@pytest.fixture(scope="module")
def setup():
    """granite-3-2b reduced: the reference's parameters and, per engine dim
    (128 = d_model, 256 = projected), one reference-built memory state."""
    jp = jax.device_get(jlm.init_params(jax.random.PRNGKey(0),
                                        jregistry.reduced_arch("granite-3-2b")))
    states = {}
    for dim in (128, 256):
        jecfg, _ = _ecfgs(dim)
        mem = np.random.default_rng(dim).normal(size=(ROWS, dim)).astype(
            np.float32)
        mem /= np.linalg.norm(mem, axis=1, keepdims=True)
        st, _ = jivf.build(jax.random.PRNGKey(1), jnp.asarray(mem),
                           jnp.arange(ROWS, dtype=jnp.int32), jecfg)
        states[dim] = jax.device_get(st)
    tokens = np.random.default_rng(2).integers(0, 512, (2, 16)).astype(
        np.int32)
    return jp, states, tokens


def _ref_projections(cfg, dim):
    """The reference step's matrices (`rag.py`: PRNGKey(0) and (1))."""
    proj = jax.random.normal(jax.random.PRNGKey(0), (cfg.d_model, dim),
                             jnp.float32) / jnp.sqrt(cfg.d_model)
    unproj = jax.random.normal(jax.random.PRNGKey(1), (dim, cfg.d_model),
                               jnp.float32) / jnp.sqrt(dim)
    return np.asarray(proj), np.asarray(unproj)


@pytest.mark.parametrize("dim,dtype", [(128, "float32"), (256, "float32"),
                                       (128, "bfloat16")])
def test_rag_prefill_matches_reference(setup, dim, dtype):
    """dim == d_model, and dim != d_model with the reference's projections
    carried across: ids, logits, caches and pos."""
    jp, states, tokens = setup
    jcfg = jregistry.reduced_arch("granite-3-2b").replace(dtype=dtype)
    cfg = registry.reduced_arch("granite-3-2b").replace(dtype=dtype)
    jecfg, ecfg = _ecfgs(dim)
    step = jax.jit(jrag.make_rag_prefill(jcfg, jecfg, s_max=32, k=K))
    jl, jc, jpos, jids = step(jp, states[dim], {"tokens": jnp.asarray(tokens)})

    model = convert.lm_params_from_numpy(cfg, jp, "cpu")
    proj = unproj = None
    if dim != cfg.d_model:
        proj, unproj = convert.rag_projections_from_numpy(
            *_ref_projections(cfg, dim), "cpu")
    prefill = rag.make_rag_prefill(cfg, ecfg, 32, k=K, proj=proj,
                                   unproj=unproj, device="cpu")
    state = convert.ivf_state_from_numpy(states[dim], "cpu")
    tl, tc, tpos, tids = prefill(model, state,
                                 {"tokens": torch.from_numpy(tokens)})

    # the retrieval: the k-th score clears the (k+1)-th by more than TOL,
    # so equal ids are a fair demand
    q = prefill.query(model, torch.from_numpy(tokens))
    ids_all, sc_all = ivf.query_full_scan(state, q, ecfg, K + 1)
    assert bool(((sc_all[:, K - 1] - sc_all[:, K]) > TOL).all())
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _, jsc, _ = jrag.retrieve(states[dim], _jquery(jp, jcfg, jecfg, tokens),
                              jecfg, K)
    np.testing.assert_allclose(sc_all[:, :K].numpy(), np.asarray(jsc),
                               rtol=TOL, atol=TOL)

    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert tpos.tolist() == [15, 15]
    want, got = np.asarray(jl.astype(jnp.float32)), tl.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                       atol=TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())
    assert tc.k.shape == jc.k.shape


FAMILIES = ["olmoe-1b-7b", "qwen2-vl-7b", "rwkv6-1.6b", "zamba2-2.7b"]


def _cache_leaves(caches):
    """Every tensor of a cache tree (KV, RWKV, zamba2's), in order."""
    if hasattr(caches, "_fields"):
        return [t for c in caches for t in _cache_leaves(c)]
    return [caches]


@pytest.mark.parametrize("dim", [128, 256])
@pytest.mark.parametrize("arch", FAMILIES)
def test_rag_prefill_matches_reference_per_family(setup, arch, dim):
    """One arch of each family the slice adds, float32, in both branches:
    ids, logits, every cache leaf (zamba2's attention caches grown to
    s_max, rwkv6's states) and pos; qwen2-vl with M-RoPE coordinates that
    differ per axis."""
    _, states, tokens = setup
    jcfg = jregistry.reduced_arch(arch).replace(dtype="float32")
    cfg = registry.reduced_arch(arch).replace(dtype="float32")
    jp = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    jecfg, ecfg = _ecfgs(dim)
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        t = np.arange(tokens.shape[1], dtype=np.int32)
        batch["mrope_pos"] = np.broadcast_to(
            np.stack([t, t // 3, t % 4], -1), (*tokens.shape, 3)).copy()
    step = jax.jit(jrag.make_rag_prefill(jcfg, jecfg, s_max=32, k=K))
    jl, jc, jpos, jids = step(jp, states[dim],
                              {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.lm_params_from_numpy(cfg, jp, "cpu")
    proj = unproj = None
    if dim != cfg.d_model:
        proj, unproj = convert.rag_projections_from_numpy(
            *_ref_projections(cfg, dim), "cpu")
    prefill = rag.make_rag_prefill(cfg, ecfg, 32, k=K, proj=proj,
                                   unproj=unproj, device="cpu")
    tl, tc, tpos, tids = prefill(
        model, convert.ivf_state_from_numpy(states[dim], "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    got, want = _cache_leaves(tc), jax.tree.leaves(jc)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    if cfg.family == "hybrid":
        assert tc.attn.k.shape[2] == 32
    # decode continues from the RAG-prefilled caches
    tok = serve_step.greedy(tl, cfg.vocab_size)[:, None]
    logits2, _ = lm.decode_step(model, cfg, tok, tc, tpos + 1)
    jl2, _ = jlm.decode_step(jp, jcfg, jnp.asarray(tok.numpy()), jc,
                             jnp.asarray((tpos + 1).numpy()))
    np.testing.assert_allclose(logits2.numpy(), np.asarray(jl2), rtol=TOL,
                               atol=TOL)


def _jquery(jp, jcfg, jecfg, tokens):
    q = jrag.embed_query(jp, jcfg, jnp.asarray(tokens))
    if jecfg.dim != jcfg.d_model:
        q = q @ jnp.asarray(_ref_projections(jcfg, jecfg.dim)[0])
    return q


def test_default_projections_are_seeded_and_device_free():
    cfg = registry.reduced_arch("granite-3-2b")
    _, ecfg = _ecfgs(256)
    a = rag.make_rag_prefill(cfg, ecfg, 32, device="cpu")
    b = rag.make_rag_prefill(cfg, ecfg, 32, device="cpu")
    assert torch.equal(a.proj, b.proj) and torch.equal(a.unproj, b.unproj)
    assert a.proj.shape == (128, 256) and a.unproj.shape == (256, 128)
    assert abs(float(a.proj.std()) * 128 ** 0.5 - 1) < 0.05
    same = rag.make_rag_prefill(cfg, _ecfgs(128)[1], 32)
    assert same.proj is None and same.unproj is None


def test_greedy_ties_and_padded_vocab():
    """Ties go to the first index (as `jnp.argmax`); ids >= vocab_size never
    win, whatever their logits."""
    logits = np.array([[1.0, 3.0, 3.0, 0.0, 9.0, 9.0],
                       [-1.0, -1.0, -5.0, -1.0, 7.0, 0.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    want = np.asarray(jserve.greedy(jnp.asarray(logits), 4))
    for dt in (torch.float32, torch.bfloat16):
        got = serve_step.greedy(torch.from_numpy(logits).to(dt), 4)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [1, 0, 0]


def test_generate_matches_reference(setup):
    """The greedy loop (prefill + 5 decode steps) in float32 gives the
    reference's tokens."""
    jp, _, tokens = setup
    jcfg = jregistry.reduced_arch("granite-3-2b").replace(dtype="float32")
    cfg = registry.reduced_arch("granite-3-2b").replace(dtype="float32")
    want = jserve.generate(jp, jcfg, {"tokens": jnp.asarray(tokens[:, :8])},
                           steps=6, s_max=16)
    model = convert.lm_params_from_numpy(cfg, jp, "cpu")
    got = serve_step.generate(model, cfg,
                              {"tokens": torch.from_numpy(tokens[:, :8])},
                              steps=6, s_max=16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rag_prefill_smoke_on_the_port():
    """The reference's `test_rag_prefill_smoke` on the port: shapes, finite
    logits, and decode continuing from the RAG-prefilled cache."""
    cfg = registry.reduced_arch("granite-3-2b")
    _, ecfg = _ecfgs(cfg.d_model)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    mem = torch.nn.functional.normalize(
        torch.randn(500, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0)), dim=1)
    state, _ = ivf.build(torch.Generator().manual_seed(1), mem,
                         torch.arange(500, dtype=torch.int32), ecfg)
    step = rag.make_rag_prefill(cfg, ecfg, s_max=32, k=4)
    batch = api.synth_batch(torch.Generator().manual_seed(2), cfg,
                            "prefill", 2, 16)
    logits, caches, pos, ids = step(params, state, batch)
    assert logits.shape == (2, cfg.vocab_padded)
    assert bool(torch.isfinite(logits.float()).all())
    assert ids.shape == (2, 4)
    tok = serve_step.greedy(logits, cfg.vocab_size)[:, None]
    logits2, _ = lm.decode_step(params, cfg, tok, caches, pos + 1)
    assert bool(torch.isfinite(logits2.float()).all())


def test_generate_loop_on_the_port():
    """The reference's `test_generate_loop` on the port."""
    cfg = registry.reduced_arch("granite-3-2b")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = api.synth_batch(torch.Generator().manual_seed(1), cfg,
                            "prefill", 2, 8)
    toks = serve_step.generate(params, cfg, batch, steps=4, s_max=16)
    assert toks.shape == (2, 4)
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())


def test_generate_serves_the_encdec_family():
    """`serve_step.generate` on seamless (the family the serve drivers
    refuse): prefill over source frames and tokens, then decode against
    the cached self and cross K/V; tokens inside the vocabulary, equal to
    the greedy tokens of teacher-forced `forward_train` calls."""
    cfg = registry.reduced_arch("seamless-m4t-large-v2").replace(
        dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = api.synth_batch(torch.Generator().manual_seed(1), cfg,
                            "prefill", 2, 16)
    toks = serve_step.generate(params, cfg, batch, steps=4, s_max=16)
    assert toks.shape == (2, 4)
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    seq = batch["tokens"]
    for t in range(4):
        logits, _ = lm.forward_train(params, cfg, {**batch, "tokens": seq})
        nxt = serve_step.greedy(logits[:, -1], cfg.vocab_size)
        assert torch.equal(nxt, toks[:, t])
        seq = torch.cat([seq, nxt[:, None]], dim=1)


def test_synth_batch_shapes_match_reference():
    for arch, kind in (("granite-3-2b", "train"), ("qwen2-vl-7b", "train"),
                       ("seamless-m4t-large-v2", "train"),
                       ("gemma2-9b", "prefill")):
        cfg, jcfg = registry.reduced_arch(arch), jregistry.reduced_arch(arch)
        got = api.synth_batch(torch.Generator().manual_seed(0), cfg, kind,
                              2, 16)
        want = japi.synth_batch(jax.random.PRNGKey(0), jcfg, kind, 2, 16)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert int(got["tokens"].max()) < cfg.vocab_size
    rng = np.random.default_rng(0)
    b = {"tokens": np.zeros((2, 8), np.int32),
         "targets": np.zeros((2, 8), np.int32)}
    for arch in ("qwen2-vl-7b", "seamless-m4t-large-v2", "granite-3-2b"):
        got = api.adapt_token_batch(b, registry.reduced_arch(arch), rng)
        want = japi.adapt_token_batch(b, jregistry.reduced_arch(arch),
                                      np.random.default_rng(0))
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------

def test_serve_main_on_cpu(capsys):
    """`python -m repro_torch.launch.serve --device cpu` at a tiny size:
    every concurrent insert acknowledged and live, tok/s named with the
    device."""
    out = serve.main(["--device", "cpu", "--requests", "2",
                      "--prompt-len", "16", "--decode-steps", "3",
                      "--corpus", "512", "--concurrent-inserts", "64"])
    text = capsys.readouterr().out
    assert "tok/s on the CPU" in text and "interpret" not in text
    assert out["insert_rows"] == 64 and out["insert_rows_per_s"] > 0
    assert out["turns"][0]["tokens"].shape == (2, 3)
    assert out["turns"][0]["ids"].shape == (2, 4)
    assert len(out["decode_ms"]) == 2 and len(out["prefill_ms"]) == 1


def test_serve_agent_main_on_cpu(capsys):
    """`python -m repro_torch.serve_agent --device cpu`: each turn's query
    embeddings become memories (live count grows by 2 a turn)."""
    from repro_torch import serve_agent
    out = serve_agent.main(["--device", "cpu", "--turns", "2",
                            "--decode-steps", "3"])
    text = capsys.readouterr().out
    assert "after 2 turns: 1028 memories" in text
    assert [t["tokens"].shape for t in out["turns"]] == [(2, 3), (2, 3)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_entry_points_serve_each_family_on_cpu(arch, capsys):
    """Both entry points at `--arch` of each family the slice adds."""
    from repro_torch import serve_agent
    out = serve.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                      "--prompt-len", "16", "--decode-steps", "3",
                      "--corpus", "512", "--concurrent-inserts", "32"])
    assert out["insert_rows"] == 32
    toks = out["turns"][0]["tokens"]
    assert toks.shape == (2, 3) and (toks < registry.get_arch(arch)
                                     .vocab_size).all()
    out = serve_agent.main(["--device", "cpu", "--arch", arch, "--turns",
                            "1", "--decode-steps", "2"])
    assert "after 1 turns: 1026 memories" in capsys.readouterr().out
    assert out["turns"][0]["tokens"].shape == (2, 2)


def test_serve_turns_and_acked_inserts_live():
    """`serve` over several turns: each turn sees a snapshot that the
    `on_turn` hook can check, and every acknowledged insert is live."""
    cfg = registry.reduced_arch("stablelm-12b")
    _, ecfg = _ecfgs(cfg.d_model)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    corpus = torch.nn.functional.normalize(
        torch.randn(600, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)), dim=1)
    svc, mem, _ = serve.build_memory(ecfg, corpus, device="cpu")
    seen = []

    def on_turn(turn, snap, batch, ids):
        q = rag.embed_query(params, cfg, batch["tokens"])
        plain, _, _ = ivf.query_full_scan_rows(snap, q, ecfg, K)
        assert torch.equal(plain, ids)
        seen.append(turn)

    try:
        out = serve.serve(cfg, ecfg, params, svc, mem, requests=3,
                          prompt_len=12, decode_steps=4, turns=3,
                          inserts=corpus[:70] * -1, insert_queries=True,
                          on_turn=on_turn)
        st = mem.snapshot()
        ids = torch.cat([st.list_ids.reshape(-1), st.spill_ids])
        live = torch.sort(ids[ids >= 0]).values
        assert torch.equal(live, torch.arange(600 + 70 + 9,
                                              dtype=torch.int32))
    finally:
        serve.close(svc)
    assert seen == [0, 1, 2] and out["insert_rows"] == 79
    assert out["tokens_generated"] == 3 * 3 * 4


def test_entry_points_need_a_card_or_a_named_device(monkeypatch):
    """Without a card and without --device the entry points raise, as
    `resolve_device` does; a projected RAG step needs a device too."""
    from repro_torch import serve_agent
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (serve.main, serve_agent.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    cfg = registry.reduced_arch("granite-3-2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rag.make_rag_prefill(cfg, _ecfgs(256)[1], 32)
