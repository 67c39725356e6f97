"""The serving path over the port's (data, model) mesh on the CPU, held
against the JAX package: reduced granite-3-2b (dense, tied embeddings;
here) and, by this file's checks, olmoe-1b-7b (4 experts, top-2;
`test_torch_mesh_moe.py`), qwen2-vl-7b (vision embeddings, non-default
M-RoPE positions; `_vlm.py`), rwkv6-1.6b (`_ssm.py`), zamba2-2.7b
(`_hybrid.py`) and seamless-m4t-large-v2 (source frames, the cross K/V;
`_encdec.py`) placed by the reference's placements on port
meshes (1, 2), (2, 1), (2, 2) and (1, 4) of "cpu", against the
reference unsharded and on its own (1, 2) / (2, 1) mesh of the two CPU
devices `tests/conftest.py` forces (``jax.sharding.Mesh``, Auto axes):
prefill logits, every leaf of the placed caches and 3 decode steps;
each placed leaf's local shape against the reference's `param_shardings`;
the 'model' replicas bit-identical; the caches' placements; the RAG
prefill's retrieved ids; olmoe's expert-parallel branch against the
reference's ``shard_map`` branch.

Tolerances: float32 to rtol = atol = 1e-4 against every reference run.
bfloat16 logits within 1e-2 of their largest magnitude, greedy tokens
equal where the reference's top-2 margin exceeds that, against the
reference run whose 'model' axis has the port mesh's width: TP rounds
each shard's partial product to bfloat16 before the sum over 'model', in
the reference as in the port, so a bfloat16 run across a 'model' axis
differs from the unsharded one by more than the products' own rounding
(the reference's own (1, 2) olmoe run is 1.7e-2 of the scale from its
unsharded run; `test_bf16_tp_gap_is_the_reference_own`).  zamba2's bound
is 2e-2 of the scale, its unsharded bound in `test_torch_models.py`
(GEMM accumulation order through its deep recurrent stack).  Width 1 is
held to the unsharded run as well, and width 4 (which needs four devices)
to the reference's own (1, 4) run in `test_torch_mesh_wide.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import registry as jregistry
from repro.configs.base import EngineConfig as JConfig
from repro.core import index as jivf
from repro.models import lm as jlm
from repro.models import sharding as jsharding
from repro.models import specs as jspecs
from repro.serving import rag as jrag
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.configs.base import EngineConfig
from repro_torch.distributed import elastic
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import serve
from repro_torch.models import lm, sharding, specs
from repro_torch.models.attention import KVCache
from repro_torch.serving import rag, serve_step

jax.config.update("jax_platform_name", "cpu")

ARCH = "granite-3-2b"
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
REF_MESHES = [(1, 2), (2, 1)]
PROMPT, S_MAX, STEPS, BATCH = 12, 32, 3, 2
SRC = 8             # seamless's source frames
VIS = 4             # qwen2-vl's vision embeddings (a 2 x 2 patch grid)
F32_TOL, BF16_REL = 1e-4, 1e-2
BF16_SCALE = {"zamba2-2.7b": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models' small products run faster on one thread than on
    the process's default pool (the files that import this fixture take
    it too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(shape):
    return Mesh(np.array(jax.devices()[:2]).reshape(shape), ("data", "model"))


def _mesh(shape):
    return lmesh.model_mesh(shape, ("data", "model"), "cpu")


def _j(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def mrope_grid(b: int, s: int, nv: int, width: int) -> np.ndarray:
    """qwen2-vl's M-RoPE positions [b, s, 3] int32 for `nv` patch
    embeddings on a grid `width` wide, then text: a patch at (0, row,
    col), each text token one past the largest coordinate before it on
    all three streams (not the positions broadcast, which is the
    default)."""
    pos = np.zeros((s, 3), np.int32)
    for i in range(nv):
        pos[i] = (0, i // width, i % width)
    start = max((nv - 1) // width, width - 1) + 1
    pos[nv:] = (start + np.arange(s - nv))[:, None]
    return np.broadcast_to(pos, (b, s, 3)).copy()


def _extras(cfg) -> dict:
    """A family's other prefill inputs (host arrays, the same for every
    run): qwen2-vl's VIS vision embeddings and `mrope_grid` positions,
    seamless's SRC source frames."""
    rng = np.random.default_rng(7)
    if cfg.family == "vlm":
        return {"vis_embeds": rng.normal(size=(BATCH, VIS, cfg.d_model))
                .astype(np.float32),
                "mrope_pos": mrope_grid(BATCH, PROMPT, VIS, 2)}
    if cfg.family == "encdec":
        return {"src_emb": rng.normal(size=(BATCH, SRC, cfg.d_model))
                .astype(np.float32)}
    return {}


def _j_leaves(tree) -> dict:
    """{dotted path: f32 host array} of a reference cache tree, the
    paths `specs.cache_leaves` gives the port's."""
    return {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                     for k in path): _j(t)
            for path, t in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reference_run(jp, jcfg, toks, shape):
    """Prefill of PROMPT tokens (and `_extras`), then STEPS decode steps
    on teacher tokens: (logits per step, the prefill's cache leaves)."""
    mesh = None if shape is None else _jmesh(shape)
    with jsharding.use_mesh(mesh):
        p = jp if mesh is None else jax.device_put(
            jp, jspecs.param_shardings(jcfg, mesh))
        prefill = jax.jit(lambda p, b: jlm.prefill(p, jcfg, b, S_MAX))
        decode = jax.jit(lambda p, t, c, q: jlm.decode_step(p, jcfg, t, c, q))
        l, c, pos = prefill(p, {"tokens": jnp.asarray(toks[:, :PROMPT]),
                                **{k: jnp.asarray(v) for k, v in
                                   _extras(jcfg).items()}})
        out = [_j(l)]
        caches = _j_leaves(c)
        assert np.asarray(pos).tolist() == [PROMPT - 1] * BATCH
        for t in range(PROMPT, PROMPT + STEPS):
            l, c = decode(p, jnp.asarray(toks[:, t: t + 1]), c,
                          jnp.full((BATCH,), t, jnp.int32))
            out.append(_j(l))
    return out, caches


@pytest.fixture(scope="module")
def oracle():
    """Per (arch, dtype): the reference's params, tokens and its runs
    unsharded (key None) and on its (1, 2) / (2, 1) meshes."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            jcfg = jregistry.reduced_arch(arch).replace(dtype=dtype)
            jp = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
            toks = np.random.default_rng(1).integers(
                0, jcfg.vocab_size, (BATCH, PROMPT + STEPS)).astype(np.int32)
            runs = {s: _reference_run(jp, jcfg, toks, s)
                    for s in [None] + REF_MESHES}
            cache[arch, dtype] = jp, toks, runs
        return cache[arch, dtype]
    return get


def _port_run(cfg, jp, toks, shape):
    sp = convert.lm_params_to_mesh(cfg, jp, _mesh(shape))
    l, c, pos = lm.prefill(sp, cfg, {
        "tokens": torch.from_numpy(toks[:, :PROMPT]),
        **{k: torch.from_numpy(v) for k, v in _extras(cfg).items()}}, S_MAX)
    assert pos.tolist() == [PROMPT - 1] * BATCH
    prefill_caches = {k: t.float().numpy() for k, t in specs.cache_leaves(
        sharding.full_tree(c))}
    out = [l]
    for t in range(PROMPT, PROMPT + STEPS):
        l, c = lm.decode_step(sp, cfg, torch.from_numpy(toks[:, t: t + 1]), c,
                              torch.full((BATCH,), t, dtype=torch.int32))
        out.append(l)
    return sp, out, prefill_caches, c


def _check_bf16(got, want, what, rel: float = BF16_REL) -> int:
    tol = rel * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)
    two = np.sort(want, axis=-1)[..., -2:]
    sure = (two[..., 1] - two[..., 0]) > tol
    np.testing.assert_array_equal(got.argmax(-1)[sure],
                                  want.argmax(-1)[sure], err_msg=what)
    return int(sure.sum())


CASES = ([("float32", s) for s in MESHES]
         + [("bfloat16", s) for s in MESHES if s != (1, 4)])


def check_prefill_and_decode(oracle, arch, dtype, shape):
    """Placed logits (gathered), the prefill's placed caches and the
    greedy tokens of 3 decode steps against the reference's runs."""
    jp, toks, runs = oracle(arch, dtype)
    cfg = registry.reduced_arch(arch).replace(dtype=dtype)
    sp, out, caches, last = _port_run(cfg, jp, toks, shape)
    for logits in out:
        assert isinstance(logits, sharding.Placed)
        assert logits.shape == (BATCH, cfg.vocab_padded)
        assert logits.dtype == getattr(torch, dtype)
    got = [t.full().float().numpy() for t in out]
    if dtype == "float32":
        refs = [None] + REF_MESHES
    else:
        refs = [s for s in REF_MESHES if s[1] == shape[1]]
        refs += [None] if shape[1] == 1 else []
    compared = 0
    for ref in refs:
        want, want_caches = runs[ref]
        for step, (g, w) in enumerate(zip(got, want)):
            what = f"step {step} vs the reference on {ref}"
            if dtype == "float32":
                np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                           err_msg=what)
            else:
                compared += _check_bf16(g, w, what,
                                        BF16_SCALE.get(arch, BF16_REL))
        ctol = F32_TOL if dtype == "float32" else 0.05
        assert caches.keys() == want_caches.keys()
        for key, a in caches.items():
            np.testing.assert_allclose(a, want_caches[key], rtol=ctol,
                                       atol=ctol, err_msg=key)
    assert refs and (compared or dtype == "float32")
    # greedy across the vocab shards == greedy of the gathered logits
    for t in out:
        assert torch.equal(serve_step.greedy(t, cfg.vocab_size),
                           serve_step.greedy(t.full(), cfg.vocab_size))
    check_cache_layout(cfg, last, sp.mesh)


def cache_layout(cfg, name: str, shape, mesh):
    """The placement the port gives cache leaf `name` of `shape` (a
    `Joined`'s: its pieces' placements and widths): the K/V as
    `KVCache.shardit` places them; the recurrent states' heads over
    'model' where they divide; rwkv6's shifts whole over 'model', and
    mamba2's conv window as its model-cut x channels beside its
    replicated B/C channels (`specs.cache_specs`, the reference's policy,
    cuts both over 'model' by their last dim, straight across that
    boundary for the window)."""
    m = sharding.axis_sizes(mesh).get("model", 1)
    be = sharding.placement((shape[1],), "batch", mesh=mesh)[0]
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("k", "v"):
        return lm.attn.kv_placement(mesh, shape)
    if leaf == "state":
        return (None, be, "model" if m > 1 and shape[2] % m == 0 else None)
    if leaf in ("x_att", "x_ffn"):
        return (None, be)
    assert leaf == "conv", name
    di = cfg.ssm_d_inner
    cut = "model" if m > 1 and cfg.ssm_heads % m == 0 else None
    return ((None, be, None, cut), (None, be)), (di, shape[3] - di)


def check_cache_layout(cfg, caches, mesh):
    """Every leaf of placed caches is placed as `cache_layout` says, each
    shard's piece the slice of the whole that its placement names."""
    for name, t in specs.cache_leaves(caches):
        assert t.mesh == mesh, name
        full = t.full()
        want = cache_layout(cfg, name, tuple(full.shape), mesh)
        if isinstance(t, sharding.Joined):
            assert tuple(p.spec for p in t.pieces) == want[0], name
            assert tuple(p.shape[3] for p in t.pieces) == want[1], name
            pieces = t.pieces
        else:
            assert isinstance(t, sharding.Placed) and t.spec == want, name
            pieces = (t,)
        for piece in pieces:
            again = sharding.place(piece.full(), piece.spec, mesh)
            for a, b in zip(piece.parts, again.parts):
                assert torch.equal(a, b), name
        if name.rsplit(".", 1)[-1] in ("k", "v"):
            with sharding.use_mesh(mesh):
                again = KVCache(full, full).shardit().k
            assert all(torch.equal(a, b) for a, b in zip(t.parts,
                                                         again.parts))


def check_placed_leaves(arch, shape):
    """Each placed leaf's placement and local shape are the reference's
    (`param_shardings` on its mesh, where it can build one; its
    `param_specs` on a mesh of the same shape otherwise)."""
    jcfg = jregistry.reduced_arch(arch)
    cfg = registry.reduced_arch(arch)
    jp = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    sp = convert.lm_params_to_mesh(cfg, jp, _mesh(shape))
    if shape in REF_MESHES:
        jm = _jmesh(shape)
        want = jax.tree_util.tree_flatten_with_path(
            jspecs.param_shardings(jcfg, jm))[0]
    else:
        fake = dataclasses.make_dataclass("M", ["axis_names", "devices"])(
            ("data", "model"), np.empty(shape, dtype=object))
        want = jax.tree_util.tree_flatten_with_path(
            jspecs.param_specs(jcfg, fake))[0]
    shapes = dict(convert._flatten(jax.tree.map(np.shape, jp)))
    assert len(want) == len(sp.specs)
    for path, sh in want:
        key = ".".join(str(k.key) for k in path)
        spec = getattr(sh, "spec", sh)
        entries = tuple(spec) + (None,) * (len(shapes[key]) - len(spec))
        mine = sp.specs[key] + (None,) * (len(shapes[key])
                                          - len(sp.specs[key]))
        norm = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in entries)
        assert mine == norm, key
        local = sharding.local_shape(shapes[key], sp.specs[key], sp.mesh)
        if hasattr(sh, "shard_shape"):
            assert local == sh.shard_shape(shapes[key]), key
        for shard in sp.shards:
            assert tuple(shard[key].shape) == local, key
    # per-shard bytes: exactly the placements' prediction
    sizes = sharding.axis_sizes(sp.mesh)
    for i in range(sp.mesh.size):
        assert sp.nbytes(i) == sum(
            specs.shard_bytes(int(np.prod(sp.shapes[k]))
                              * sp.shards[i][k].element_size(), s, sizes)
            for k, s in sp.specs.items())


def check_replicas(arch, shape):
    """The 'model' shards of a data block hold the same activations after
    every block, bit for bit (each sum over 'model' runs in one order;
    seamless's encoder output too), and so the same pieces of every cache
    leaf placed whole over 'model' (K/V of kv heads that do not divide,
    rwkv6's shifts, mamba2's B/C window)."""
    cfg = registry.reduced_arch(arch)
    params = lm.init_params(torch.Generator().manual_seed(3), cfg)
    sp = specs.place_params(params, cfg, _mesh(shape))
    toks = torch.randint(0, cfg.vocab_size, (2, 10),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32)
    extra = {k: torch.from_numpy(v[:, :10] if k == "mrope_pos" else v)
             for k, v in _extras(cfg).items()}
    xs, call = lm.embed_mesh(sp, cfg, toks, extra.get("vis_embeds"))
    groups = sharding.groups(sp.mesh, ("model",))

    def same(parts, what):
        for g in groups:
            for i in g[1:]:
                assert torch.equal(parts[i], parts[g[0]]), what

    if cfg.family == "encdec":
        enc = lm._encode_mesh(sp, cfg, call, extra["src_emb"])
        same(enc, "encoder output")
        xs, local = lm._decode_stack_mesh(sp, xs, cfg, call, mode="prefill",
                                          enc_outs=enc, s_max=16)
    else:
        xs, local, _ = lm._run_stack_mesh(sp, xs, cfg, call, mode="prefill",
                                          s_max=16)
    same(xs, "activations")
    placed = lm._placed_caches(cfg, call, local, 16)
    for name, t in specs.cache_leaves(placed):
        for piece in getattr(t, "pieces", (t,)):
            if not any("model" in sharding.entry_axes(e)
                       for e in piece.spec):
                same(piece.parts, name)
    if cfg.family in ("dense", "moe", "vlm"):
        assert call.kv_local == (cfg.num_kv_heads // shape[1]
                                 if cfg.num_kv_heads % shape[1] == 0
                                 else cfg.num_kv_heads)


def check_reshard_restore(arch, tmp_path):
    """A model placed on (2, 2) saved leaf by leaf as it is placed (the
    reference's tree, `param_shardings`' layout), restored onto (1, 4) and
    (4, 1): every leaf torch.equal to the saved one, each shard's piece
    cut by the new mesh's placements, and the restored model's prefill
    logits equal to the saved model's on a mesh of its own shape."""
    cfg = registry.reduced_arch(arch).replace(dtype="float32")
    sp = specs.place_params(
        lm.init_params(torch.Generator().manual_seed(5), cfg), cfg,
        _mesh((2, 2)))
    placed = {k: sp.placed(k) for k in sp.specs}

    def fill(node, path=()):
        return {k: fill(v, path + (k,)) if isinstance(v, dict) else
                placed[".".join(path + (k,))] for k, v in node.items()}

    tree = fill(specs.param_shardings(cfg, sp.mesh))
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(3, tree)
    toks = torch.randint(0, cfg.vocab_size, (4, 8),
                         generator=torch.Generator().manual_seed(6),
                         dtype=torch.int32)
    for shape in ((1, 4), (4, 1)):
        mesh = _mesh(shape)
        back = elastic.reshard_restore(ckpt, tree, mesh, cfg, step=3)
        assert back.mesh == mesh and back.specs.keys() == sp.specs.keys()
        want = dict(convert._flatten(specs.param_shardings(cfg, mesh)))
        for key in sp.specs:
            assert back.specs[key] == want[key].spec, key
            assert torch.equal(back.placed(key).full(), placed[key].full()), \
                key
            local = sharding.local_shape(back.shapes[key], back.specs[key],
                                         mesh)
            assert all(tuple(d[key].shape) == local for d in back.shards)
        again = specs.place_params(specs.gather_params(sp, "cpu"), cfg, mesh)
        got, _, _ = lm.prefill(back, cfg, {"tokens": toks}, 8)
        ref, _, _ = lm.prefill(again, cfg, {"tokens": toks}, 8)
        assert torch.equal(got.full(), ref.full())


# ---------------------------------------------------------------------------
# the RAG prefill over a mesh
# ---------------------------------------------------------------------------

ROWS, K = 500, 4


def _rag_extras(cfg, tokens) -> dict:
    """qwen2-vl's RAG batch carries `mrope_grid` positions (the prefix
    splice takes no vision embeddings, as the reference's)."""
    if cfg.family != "vlm":
        return {}
    return {"mrope_pos": mrope_grid(*tokens.shape, VIS, 2)}


@pytest.fixture(scope="module")
def rag_oracle():
    """Per arch (float32): the reference's params, memory state, tokens
    and its RAG prefill's (logits, caches, pos, ids) unsharded (qwen2-vl
    at `_rag_extras`' M-RoPE positions)."""
    kw = dict(dim=128, n_clusters=128, list_capacity=16, nprobe=8, k=K,
              kmeans_iters=2)
    jecfg, ecfg = JConfig(interpret=True, **kw), EngineConfig(**kw)
    mem = np.random.default_rng(5).normal(size=(ROWS, 128)).astype(
        np.float32)
    mem /= np.linalg.norm(mem, axis=1, keepdims=True)
    st, _ = jivf.build(jax.random.PRNGKey(1), jnp.asarray(mem),
                       jnp.arange(ROWS, dtype=jnp.int32), jecfg)
    jstate = jax.device_get(st)
    tokens = np.random.default_rng(2).integers(0, 512, (2, 16)).astype(
        np.int32)
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jregistry.reduced_arch(arch).replace(dtype="float32")
            jp = jax.device_get(jlm.init_params(jax.random.PRNGKey(0), jcfg))
            step = jax.jit(jrag.make_rag_prefill(jcfg, jecfg, s_max=S_MAX,
                                                 k=K))
            cache[arch] = jp, step(jp, jstate, {
                "tokens": jnp.asarray(tokens),
                **{k: jnp.asarray(v)
                   for k, v in _rag_extras(jcfg, tokens).items()}})
        return (ecfg, jstate, tokens) + cache[arch]
    return get


def check_rag_prefill(rag_oracle, arch, shape):
    """float32: the retrieved ids equal the reference's, the logits and
    every leaf of the prefix-spliced caches within 1e-4, then one decode
    step."""
    ecfg, jstate, tokens, jp, (jl, jc, jpos, jids) = rag_oracle(arch)
    jcfg = jregistry.reduced_arch(arch).replace(dtype="float32")
    cfg = registry.reduced_arch(arch).replace(dtype="float32")

    sp = convert.lm_params_to_mesh(cfg, jp, _mesh(shape))
    prefill = rag.make_rag_prefill(cfg, ecfg, S_MAX, k=K, device="cpu")
    state = convert.ivf_state_from_numpy(jstate, "cpu")
    tl, tc, tpos, tids = prefill(sp, state, {
        "tokens": torch.from_numpy(tokens),
        **{k: torch.from_numpy(v)
           for k, v in _rag_extras(cfg, tokens).items()}})
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(tl.full().numpy(), np.asarray(jl),
                               rtol=F32_TOL, atol=F32_TOL)
    want = _j_leaves(jc)
    got = dict(specs.cache_leaves(sharding.full_tree(tc)))
    assert got.keys() == want.keys()
    for key, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[key], rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=key)
    # the query embedding is the one-device model's
    one = convert.lm_params_from_numpy(cfg, jp, "cpu")
    assert torch.equal(rag.embed_query(sp, cfg, torch.from_numpy(tokens)),
                       rag.embed_query(one, cfg, torch.from_numpy(tokens)))
    tok = serve_step.greedy(tl, cfg.vocab_size)[:, None]
    l2, _ = lm.decode_step(sp, cfg, tok, tc, tpos + 1)
    jl2, _ = jlm.decode_step(jp, jcfg, jnp.asarray(tok.numpy()), jc,
                             jnp.asarray((tpos + 1).numpy()))
    np.testing.assert_allclose(l2.full().numpy(), np.asarray(jl2),
                               rtol=F32_TOL, atol=F32_TOL)


def test_serve_over_a_mesh_answers_as_on_one_device():
    """`launch.serve.serve(mesh=)`: each turn the same retrieved ids and
    tokens as the one-device model on that turn's snapshot and batch
    (float32), every insert live.  The inserts run concurrently, so which
    of them a turn's snapshot holds depends on timing: each turn is held
    against the one-device run on its own snapshot, never against
    another serve run's."""
    cfg = registry.reduced_arch("granite-3-2b").replace(dtype="float32")
    ecfg = EngineConfig(dim=cfg.d_model, n_clusters=128, list_capacity=16,
                        nprobe=8, k=K, kmeans_iters=2)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    corpus = torch.nn.functional.normalize(
        torch.randn(400, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)), dim=1)
    steps = 4
    prefill = rag.make_rag_prefill(cfg, ecfg, 10 + steps + 1, k=K,
                                   device="cpu")
    decode = serve_step.make_decode(cfg)
    for mesh in (None, _mesh((2, 2))):
        want = []

        def on_turn(turn, snap, batch, ids):
            logits, caches, pos, mem_ids = prefill(params, snap, batch)
            tok = serve_step.greedy(logits, cfg.vocab_size)[:, None]
            toks = [tok]
            for _ in range(steps - 1):
                pos = pos + 1
                tok, caches = decode(params, tok, caches, pos)
                toks.append(tok)
            want.append({"ids": mem_ids.numpy(),
                         "tokens": torch.cat(toks, dim=1).numpy()})

        svc, mem, _ = serve.build_memory(ecfg, corpus, device="cpu",
                                         mesh=mesh)
        try:
            out = serve.serve(cfg, ecfg, params, svc, mem, requests=2,
                              prompt_len=10, decode_steps=steps, turns=2,
                              inserts=corpus[:40] * -1, insert_queries=True,
                              on_turn=on_turn, mesh=mesh)
            st = mem.snapshot()
            ids = torch.cat([st.list_ids.reshape(-1), st.spill_ids])
            assert torch.equal(torch.sort(ids[ids >= 0]).values,
                               torch.arange(444, dtype=torch.int32))
        finally:
            serve.close(svc)
        assert len(want) == len(out["turns"]) == 2
        for a, b in zip(want, out["turns"]):
            np.testing.assert_array_equal(a["ids"], b["ids"])
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_mesh_refusals():
    cfg = registry.reduced_arch("granite-3-2b")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.zeros((2, 4), dtype=torch.int32)
    mesh = _mesh((1, 2))
    with sharding.use_mesh(mesh):
        with pytest.raises(ValueError, match="place_params"):
            lm.prefill(params, cfg, {"tokens": toks}, 8)
    sp = specs.place_params(params, cfg, mesh)
    with sharding.use_mesh(_mesh((2, 1))):
        with pytest.raises(ValueError, match="another mesh"):
            lm.prefill(sp, cfg, {"tokens": toks}, 8)
    with sharding.use_mesh(mesh):
        logits, _, _ = lm.prefill(sp, cfg, {"tokens": toks}, 8)
    assert logits.mesh == mesh
    with pytest.raises(ValueError, match="another mesh"):
        with sharding.use_mesh(_mesh((2, 1))):
            lm.forward_train(sp, cfg, {"tokens": toks})
    train_logits, _ = lm.forward_train(sp, cfg, {"tokens": toks})
    assert train_logits.mesh == mesh
    assert train_logits.shape == (2, 4, cfg.vocab_padded)
    # every family runs placed, forward_train too (its logits placed)
    for arch in ("olmoe-1b-7b", "rwkv6-1.6b", "qwen2-vl-7b", "zamba2-2.7b",
                 "seamless-m4t-large-v2"):
        other = registry.reduced_arch(arch)
        osp = specs.place_params(
            lm.init_params(torch.Generator().manual_seed(0), other), other,
            mesh)
        batch = {"tokens": toks}
        if other.family == "encdec":
            batch["src_emb"] = torch.zeros((2, 4, other.d_model))
        logits, caches, _ = lm.prefill(osp, other, batch, 8)
        assert logits.mesh == mesh
        assert all(t.mesh == mesh for _, t in specs.cache_leaves(caches))
        train_logits, _ = lm.forward_train(osp, other, batch)
        assert train_logits.mesh == mesh
        assert train_logits.shape == (2, 4, other.vocab_padded)
        with sharding.use_mesh(_mesh((2, 1))):
            with pytest.raises(ValueError, match="another mesh"):
                lm.prefill(osp, other, batch, 8)


# ---------------------------------------------------------------------------
# granite-3-2b
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,shape", CASES)
def test_mesh_prefill_and_decode_match_reference(oracle, dtype, shape):
    check_prefill_and_decode(oracle, ARCH, dtype, shape)


@pytest.mark.parametrize("shape", MESHES)
def test_placed_leaves_match_reference_shardings(shape):
    check_placed_leaves(ARCH, shape)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_model_replicas_are_bit_identical(shape):
    check_replicas(ARCH, shape)


@pytest.mark.parametrize("shape", MESHES)
def test_rag_prefill_on_mesh_matches_reference(rag_oracle, shape):
    check_rag_prefill(rag_oracle, ARCH, shape)
