"""Shared inputs of the LM parity tests: the reference's and the port's
smoke configs, seeded weights in the reference's `init_params` layout of
any family (as jnp arrays and as the numpy float32 tree the port takes),
batches, the reference's gradient of a port parameter, and the decoder
family's logits, loss and gradients on both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jconfigs
from repro.models import registry as jmodels
from repro.models import transformer as jtransformer

from repro_torch import interop
from repro_torch.configs import registry as tconfigs
from repro_torch.models import transformer as ttransformer

B, S = 2, 32


def compiled(fn, *args):
    """`jax.jit(fn)` compiled for `args` at LLVM's lowest optimization
    level: compiling is most of these tests' time, and the level changes
    no floating-point semantics (XLA's CPU backend runs without fast
    math either way)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def cfgs(arch, dtype):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype))


def weights(jcfg, seed=0):
    """(reference tree of jnp arrays in the config's dtypes, the same tree
    as numpy float32) from seeded normals: weights scaled by 1/sqrt(fan
    in), the embedding unit normal, norm gains N(0, 0.1)."""
    shapes = jax.eval_shape(jmodels.build(jcfg).init_params,
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "embed" in name:
            a = rng.normal(size=s.shape)
        elif len(s.shape) >= 2 + ("layers" in name):
            a = rng.normal(size=s.shape) / np.sqrt(s.shape[-2])
        else:
            a = 0.1 * rng.normal(size=s.shape)
        return jnp.asarray(a.astype(np.float32)).astype(s.dtype)

    jtree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jtree, jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                               jtree)


def batch(cfg, dtype, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": toks,
           "labels": np.where(np.arange(S) % 7 == 0, -1, toks
                              ).astype(np.int32)}
    extra = {"vlm": ("vision_embeds", cfg.vision_patches),
             "audio": ("frames", cfg.encoder_seq)}.get(cfg.family)
    if extra:
        name, rows = extra
        x = jnp.asarray(rng.normal(size=(B, rows, cfg.d_model)).astype(
            np.float32))
        out[name] = np.asarray(x.astype(dtype).astype(jnp.float32))
    return out


def ref_grad_of(jgrads, name):
    """The reference's gradient for a port parameter name: a stacked
    layer axis (`interop.STACKED`) indexed by the block, a list (zamba2's
    ``shared``) by its position."""
    parts = name.split(".")
    if parts[0] in interop.STACKED:
        node = jgrads[interop.STACKED[parts[0]]]
        for k in parts[2:]:
            node = node[k]
        return np.asarray(node[int(parts[1])], np.float32)
    node = jgrads
    for k in parts:
        node = node[int(k)] if isinstance(node, list) else node[k]
    return np.asarray(node, np.float32)


def n_port_leaves(jgrads, model) -> int:
    """The port parameters a reference tree of gradients stands for: each
    stacked leaf once a block, every other leaf once."""
    n = 0
    for path, _ in jax.tree_util.tree_leaves_with_path(jgrads):
        key = path[0].key
        stacks = {v: k for k, v in interop.STACKED.items()}
        n += len(getattr(model, stacks[key])) if key in stacks else 1
    return n


def assert_grads_equal(jgrads, model):
    """Every port gradient equal to the reference's at 1e-4, and one port
    parameter for each leaf the reference's tree stands for."""
    names = []
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.float().numpy(),
                                   ref_grad_of(jgrads, name),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        names.append(name)
    assert len(names) == n_port_leaves(jgrads, model)


def run_both(arch, dtype, grads=True):
    """The reference's logits, loss and (with `grads`) gradients, in one
    jitted function, and the port's on the CPU, on the same weights and
    batch.  Without `grads` the gradients come back as None."""
    jcfg, tcfg = cfgs(arch, dtype)
    jtree, ntree = weights(jcfg)
    bt = batch(tcfg, getattr(jnp, dtype))
    jb = {k: jnp.asarray(v) for k, v in bt.items()}
    if "vision_embeds" in jb:
        jb["vision_embeds"] = jb["vision_embeds"].astype(getattr(jnp, dtype))

    def ref(params, b):
        if grads:
            loss, g = jax.value_and_grad(jtransformer.train_loss)(
                params, jcfg, b)
        else:
            loss, g = jtransformer.train_loss(params, jcfg, b), None
        logits, _, _ = jtransformer.forward(
            params, jcfg, b["tokens"], vision_embeds=b.get("vision_embeds"))
        return logits, loss, g
    jlogits, jloss, jgrads = compiled(ref, jtree, jb)(jtree, jb)

    model = interop.lm_params_from_numpy(tcfg, ntree, device="cpu")
    tb = {k: torch.tensor(v) for k, v in bt.items()}
    if "vision_embeds" in tb:
        tb["vision_embeds"] = tb["vision_embeds"].to(
            getattr(torch, dtype))
    with torch.no_grad():
        tlogits, _, _ = ttransformer.forward(
            model, tcfg, tb["tokens"], vision_embeds=tb.get("vision_embeds"))
    with torch.set_grad_enabled(grads):
        loss = ttransformer.train_loss(model, tcfg, tb)
    if grads:
        loss.backward()
    return (jlogits, jloss, jgrads), (tlogits, loss, model)
