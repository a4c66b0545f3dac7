"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
numpy-made params of a JAX model, one round's inputs, the JAX
package's sequential round oracle, the padded-step check of the local
trainer, and the attention cases held against its Pallas
``flash_attention`` in interpret mode.

The oracle's cost is compilation, so what is compiled is built once per
process and shared by every case that can share it:

- ``make_local_train_fn`` of the JAX engine returns one function object
  per (model, client config, task, dtype) while :func:`jax_round_fn`
  builds a round fn, and ``jax.jit`` of one function object compiles it
  once: cases that differ only in the server step or the aggregator
  share the compiled local step;
- server updates, models, params and round inputs are cached by value;
- :func:`jax_round` caches whole oracle rounds, so a test that needs the
  same round as another (the bf16 bound's f32 reference) reuses it.

The JAX engine itself is not changed: the shared local-train factory is
patched in only while a round fn is being built.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import config as jcfg
from colearn_federated_learning_tpu.data import core as jcore
from colearn_federated_learning_tpu.data import loader as jloader
from colearn_federated_learning_tpu.models import build_model as jbuild
from colearn_federated_learning_tpu.ops.pallas_attention import (
    flash_attention as jflash,
)
from colearn_federated_learning_tpu.parallel import round_engine as jengine
from colearn_federated_learning_tpu.server.aggregation import (
    make_server_update_fn as jserver,
)
from colearn_federated_learning_tpu_torch import config as tcfg
from colearn_federated_learning_tpu_torch.client.trainer import (
    make_local_train_fn,
)
from colearn_federated_learning_tpu_torch.models import build_model
from colearn_federated_learning_tpu_torch.models.convert import flax_to_torch
from colearn_federated_learning_tpu_torch.ops import flash_attention as fa
from colearn_federated_learning_tpu_torch.ops.attention import (
    causal_attention,
    full_attention,
    merge_heads,
    split_heads,
)
from colearn_federated_learning_tpu_torch.ops.ring_attention import (
    blockwise_attention,
)
from colearn_federated_learning_tpu_torch.parallel.round_engine import (
    make_sequential_round_fn,
)
from colearn_federated_learning_tpu_torch.server.aggregation import (
    make_server_update_fn,
)
from colearn_federated_learning_tpu_torch.utils.trees import ParamLayout

NUM_CLASSES = {"lenet5": 10, "resnet18": 10, "bert_tiny": 0,
               "mobilenetv2": 62}
BATCH, LR = 8, 0.05


def _key(kw):
    return tuple(sorted(kw.items()))


def _input_spec(name, kw):
    if name == "bert_tiny":
        return (kw.get("seq_len", 80),), jnp.int32
    return {"lenet5": (28, 28, 1), "resnet18": (32, 32, 3),
            "mobilenetv2": (28, 28, 1)}[name], jnp.float32


@functools.lru_cache(maxsize=None)
def _jax_model(name, kw):
    return jbuild(name, NUM_CLASSES[name], **dict(kw))


def jax_model(name, **kw):
    return _jax_model(name, _key(kw))


@functools.lru_cache(maxsize=None)
def _param_shapes(name, kw):
    shape, dtype = _input_spec(name, dict(kw))
    jm = _jax_model(name, kw)
    return jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1,) + shape, dtype)))["params"]


def param_shapes(name, **kw):
    """The JAX model's params tree as ``ShapeDtypeStruct`` leaves
    (``eval_shape`` of its init: traced once per model, no compile)."""
    return _param_shapes(name, _key(kw))


@functools.lru_cache(maxsize=None)
def _params(name, seed, kw):
    shapes = _param_shapes(name, kw)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        z = rng.normal(size=s.shape).astype(np.float32)
        if leaf == "kernel":
            return z / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        return (1.0 + 0.1 * z) if leaf == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def model_params(name, seed, **kw):
    """numpy-made params of the JAX model's tree: fan-in-scaled kernels,
    norm scales near 1, small biases, embeddings and positions. The
    attention backend does not change the tree."""
    kw = {k: v for k, v in kw.items() if k not in ("attention", "block_size")}
    return _params(name, seed, _key(kw))


@functools.lru_cache(maxsize=None)
def _round_inputs(dataset, cohort_size, cap, seed, kw):
    kw = dict(kw)
    text = dataset == "shakespeare"
    dc = jcfg.DataConfig(
        name=dataset, num_clients=8 if text else 6,
        partition="natural" if text else "dirichlet", dirichlet_alpha=0.5,
        synthetic_train_size=256 if text else 192, synthetic_test_size=16,
        max_examples_per_client=cap, data_dir="/nonexistent")
    cc = jcfg.ClientConfig(local_epochs=1, batch_size=BATCH, lr=LR)
    fed = jcore.build_federated_data(dc, seed=seed, **kw)
    shape = jloader.compute_round_shape(fed, cc, dc)
    idx, spec, n_ex = jloader.make_round_spec(
        fed, np.arange(cohort_size), shape,
        np.random.default_rng((seed, 7919, 0)))
    mask = jloader.mask_from_spec(spec, shape)
    return fed, idx, mask, n_ex


def round_inputs(dataset, cohort_size, cap, seed=3, **model_kw):
    """The federated corpus and one round's ``idx``/``mask``/``n_ex``
    for the first ``cohort_size`` clients (JAX's host pipeline)."""
    kw = {k: v for k, v in model_kw.items() if k in ("vocab_size", "seq_len")}
    return _round_inputs(dataset, cohort_size, cap, seed, _key(kw))


@functools.lru_cache(maxsize=None)
def _jax_server(fields):
    return jserver(jcfg.ServerConfig(**dict(fields)))


def jax_server(**fields):
    """``(init, update)`` of the JAX server step, one per config."""
    return _jax_server(_key(fields))


_LOCAL_TRAIN = {}
_make_local_train_fn = jengine.make_local_train_fn


def _shared_local_train_fn(model, client_cfg, dp_cfg, task, **kw):
    key = (repr(model), repr(client_cfg), repr(dp_cfg), task,
           repr(sorted(kw.items())))
    if key not in _LOCAL_TRAIN:
        _LOCAL_TRAIN[key] = _make_local_train_fn(model, client_cfg, dp_cfg,
                                                 task, **kw)
    return _LOCAL_TRAIN[key]


def jax_round_fn(model, task, server_update, lr=LR, client=None, **kw):
    """The JAX package's ``make_sequential_round_fn`` for ``model``, with
    the local step shared across calls (see the module doc).
    ``client``: extra ClientConfig fields (momentum, prox_mu, ...)."""
    cc = jcfg.ClientConfig(local_epochs=1, batch_size=BATCH, lr=lr,
                           **(client or {}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "make_local_train_fn", _shared_local_train_fn)
        return jengine.make_sequential_round_fn(
            model, cc, jcfg.DPConfig(), task, server_update, **kw)


def _task(dataset):
    return "lm" if dataset == "shakespeare" else "classify"


@functools.lru_cache(maxsize=None)
def _jax_round(name, dataset, cohort_size, cap, server, engine, model_kw,
               lr, local_dtype, seed, client):
    model_kw, server, engine = dict(model_kw), dict(server), dict(engine)
    fed, idx, mask, n_ex = round_inputs(dataset, cohort_size, cap, **model_kw)
    jm = jax_model(name, **model_kw)
    fp = model_params(name, seed, **model_kw)
    jinit, jupdate = jax_server(**server)
    round_fn = jax_round_fn(
        jm, _task(dataset), jupdate, lr=lr, client=dict(client),
        local_dtype=jnp.bfloat16 if local_dtype == "bfloat16" else None,
        fused_apply=server.get("fused_apply", False), **engine)
    jopt = jinit(fp)
    if server.get("optimizer") == "fedavgm":  # non-zero incoming momentum
        jopt = jax.tree.map(lambda a: a + 0.01 if a.ndim else a, jopt)
    byz = engine_byz(cohort_size) if engine.get("attack") else None
    jp, jopt2, jmet = round_fn(
        fp, jopt, jnp.asarray(fed.train_x), jnp.asarray(fed.train_y),
        jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(n_ex),
        jax.random.PRNGKey(0), byz=None if byz is None else jnp.asarray(byz))
    return (jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jopt2),
            float(jmet.train_loss), float(jmet.examples))


def engine_byz(cohort_size):
    """The byzantine mask of the attacked cases: the fourth cohort slot."""
    byz = np.zeros(cohort_size, np.float32)
    byz[3] = 1.0
    return byz


def jax_round(name, dataset, cohort_size, cap, server=None, engine=None,
              lr=LR, local_dtype=None, seed=7, client=None, **model_kw):
    """One oracle round from :func:`model_params`: ``(params′, opt′,
    train loss, examples)`` as numpy, cached by every argument.
    ``server``: ServerConfig fields; ``engine``: extra knobs of the round
    fn (aggregator, attack, ...); ``client``: extra ClientConfig
    fields."""
    return _jax_round(name, dataset, cohort_size, cap, _key(server or {}),
                      _key(engine or {}), _key(model_kw), lr, local_dtype,
                      seed, _key(client or {}))


def port_round(name, dataset, cohort_size, cap, server=None, engine=None,
               lr=LR, local_dtype=None, seed=7, byz=None, client=None,
               **model_kw):
    """The same round through the port from the same params: ``(flat
    params′, layout, opt′, RoundMetrics)``."""
    server, engine = dict(server or {}), dict(engine or {})
    fed, idx, mask, n_ex = round_inputs(dataset, cohort_size, cap, **model_kw)
    model = build_model(name, NUM_CLASSES[name], **model_kw)
    tp = flax_to_torch(model_params(name, seed, **model_kw), model)
    layout = ParamLayout.from_params(tp)
    flat = layout.flatten(tp)
    tinit, tupdate = make_server_update_fn(tcfg.ServerConfig(**server))
    topt = tinit(flat)
    if server.get("optimizer") == "fedavgm":
        topt["opt"]["trace"] += 0.01
    tround = make_sequential_round_fn(
        model, tcfg.ClientConfig(local_epochs=1, batch_size=BATCH, lr=lr,
                                  **(client or {})),
        tupdate, layout, local_dtype, task=_task(dataset), **engine)
    topt2, tmet = tround(flat, topt, torch.from_numpy(fed.train_x),
                         torch.from_numpy(fed.train_y).long(),
                         torch.from_numpy(idx.astype(np.int64)),
                         torch.from_numpy(mask), n_ex, mask.sum(-1), byz)
    return flat, layout, topt2, tmet


def check_padded_step_is_noop(local_dtype, **client):
    """Appending all-zero-mask steps to a LeNet client's grid changes
    nothing, bit for bit, under the ClientConfig fields ``client``; the
    real steps do move the params."""
    model = build_model("lenet5", 10)
    fp = model_params("lenet5", seed=1)
    tp = flax_to_torch(fp, model)
    layout = ParamLayout.from_params(tp)
    flat = layout.flatten(tp)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (40, 28, 28, 1)).astype(np.uint8))
    y = torch.from_numpy(rng.integers(0, 10, 40)).long()
    idx = torch.from_numpy(rng.integers(0, 40, (4, 8)))
    mask = torch.ones(4, 8)
    mask[1, 5:] = 0.0
    train = make_local_train_fn(
        model, tcfg.ClientConfig(batch_size=8, **client), local_dtype)
    base, base_m = train(flat, layout, x, y, idx[:2], mask[:2],
                         mask[:2].sum(-1).numpy())
    mask[2:] = 0.0
    padded, pad_m = train(flat, layout, x, y, idx, mask, mask.sum(-1).numpy())
    assert base.dtype == local_dtype
    assert not torch.equal(base.float(), flat)
    assert torch.equal(padded, base)
    assert torch.equal(pad_m.loss, base_m.loss)
    assert pad_m.examples == base_m.examples == 13.0


def flat_delta(params, start):
    """The round delta as one f64 vector over the port's layout order."""
    names = list(start)
    return np.concatenate([
        (np.asarray(params[n], np.float64) - np.asarray(start[n], np.float64))
        .ravel() for n in names])


# (b, t, d, heads, block, causal): tests/test_pallas_attention.py's
# geometries (several q and kv blocks; the LM config's T = 80 in one
# block) and its ragged lengths with blocks of 32
ATTENTION_CASES = [(2, 64, 64, 2, 16, True), (2, 64, 64, 2, 16, False),
                   (2, 80, 128, 2, 80, True)] + [
    (1, t, 64, 2, 32, c) for t in (48, 197, 50) for c in (True, False)]


def attention_case_id(case):
    return (f"t{case[1]}-d{case[2]}-bk{case[4]}-"
            f"{'causal' if case[5] else 'full'}")


def attention_qkv(b, t, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, d)).astype(dtype) for _ in range(3))


@functools.lru_cache(maxsize=None)
def jax_flash_attention(b, t, d, heads, block, causal):
    """The JAX kernel's output on one of :data:`ATTENTION_CASES`, once
    per process."""
    q, k, v = (jnp.asarray(x)
               for x in attention_qkv(b, t, d, seed=t + causal))
    return np.asarray(jflash(q, k, v, heads, causal, block, block))


def port_attention(backend, q, k, v, heads, block, causal):
    """The port's attention on ``[B, T, D]`` through ``backend``:
    ``full``, ``blockwise``, ``reference`` (the plain version of the CUDA
    kernel on ``[B·H, T, hd]``) or ``flash`` (its ``autograd.Function``)."""
    if backend == "reference":
        rows = [split_heads(x, heads).reshape(-1, *x.shape[1:2],
                                              x.shape[2] // heads)
                for x in (q, k, v)]
        out = fa.attention_reference(*rows, causal, block, block)
        return merge_heads(out.reshape(q.shape[0], heads, *out.shape[1:]))
    if backend == "blockwise":
        if q.shape[1] % block:
            # blockwise needs a block that divides T: 48 → 16, 50 → 10,
            # 197 → 1
            block = next(s for s in (16, 10, 1) if q.shape[1] % s == 0)
        return blockwise_attention(q, k, v, heads, block, causal)
    if backend == "full":
        return (causal_attention if causal else full_attention)(q, k, v,
                                                                heads)
    return fa.flash_attention(q, k, v, heads, causal, block, block)


def check_backend_against_jax_flash(case, backend, tol):
    """One of :data:`ATTENTION_CASES` through ``backend``, held against
    the JAX kernel's output within ``tol``."""
    b, t, d, heads, block, causal = case
    want = jax_flash_attention(*case)
    q, k, v = (torch.from_numpy(x)
               for x in attention_qkv(b, t, d, seed=t + causal))
    got = port_attention(backend, q, k, v, heads, block, causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **tol)
