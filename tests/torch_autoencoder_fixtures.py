"""Shared helpers of the autoencoder-branch parity tests: JAX modules at
the JAX tests' small config (32px, latent 32, n_mlp 2, channel multiplier
1; encoders on a narrow channel map so the files stay light), their
variables with seeded non-trivial values (BatchNorm statistics, the
decoder's noise weights and biases), and the port's modules carrying the
same weights."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from synthesis_in_style_tpu.losses.lpips import LPIPS as JaxLPIPS
from synthesis_in_style_tpu.models import autoencoder as jae
from synthesis_in_style_tpu.models import encoder as jenc
from synthesis_in_style_tpu.models.stylegan2 import Generator as JaxGenerator
from synthesis_in_style_tpu_torch.losses.lpips import LPIPS
from synthesis_in_style_tpu_torch.models import autoencoder as tae
from synthesis_in_style_tpu_torch.models import encoder as tenc
from synthesis_in_style_tpu_torch.models.stylegan2 import Generator
from synthesis_in_style_tpu_torch.utils.checkpoint import (
    alexnet_features_params_from_jax,
    autoencoder_params_from_jax,
)

SIZE, LATENT, N_MLP = 32, 32, 2
SCM = {32: 16, 16: 32, 8: 32, 4: 32}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturb(variables, seed: int = 5):
    """Seeded values where a fresh init is degenerate: BatchNorm statistics
    (means ~N(0, 0.1), variances in [0.5, 1.5]), and the decoder's noise
    weights and biases (+0.1 N(0, 1)), so those paths are compared too."""
    rs = np.random.RandomState(seed)

    def stats(path, x):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (0.5 + rs.rand(*x.shape)).astype(np.float32)
        return (0.1 * rs.randn(*x.shape)).astype(np.float32)

    def params(path, x):
        name = jax.tree_util.keystr(path)
        if "decoder" in name and ("noise" in name and "weight" in name
                                  or name.endswith("['bias']")):
            return (x + 0.1 * rs.randn(*x.shape)).astype(np.float32)
        return x

    out = dict(numpy_tree(variables))
    out["params"] = jax.tree_util.tree_map_with_path(params, out["params"])
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(stats, out["batch_stats"])
    return out


def jax_decoder(style_dim: int = LATENT, size: int = SIZE):
    return JaxGenerator(size=size, style_dim=style_dim, n_mlp=N_MLP, channel_multiplier=1)


def port_decoder(style_dim: int = LATENT, size: int = SIZE):
    return Generator(size, style_dim, N_MLP, channel_multiplier=1)


def _draw(path, leaf, rs):
    """A value for one variable of a fresh JAX init, by the JAX package's
    initializers: flax kernels lecun-normal, equal-lr weights and inputs
    N(0, 1) (the mapping MLP's N(0, 1 / lr_mlp)), noise weights and biases
    0 (a modulation's bias 1), BatchNorm
    scales and running variances 1, noise maps N(0, 1)."""
    names = [getattr(k, "key", None) for k in path]
    name = names[-1]
    if name == "kernel":
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rs.randn(*leaf.shape) / np.sqrt(fan_in)
    if name == "weight" and "noise" in names[-2:-1]:
        return np.zeros(leaf.shape)
    if name == "weight" and names[-2].startswith("style_"):  # the mapping MLP, lr_mlp 0.01
        return rs.randn(*leaf.shape) / 0.01
    if name in ("weight", "input") or names[0] == "noises":
        return rs.randn(*leaf.shape)
    if name == "bias":
        return np.full(leaf.shape, 1.0 if "modulation" in names else 0.0)
    if name in ("scale", "var"):
        return np.ones(leaf.shape)
    if name == "mean":
        return np.zeros(leaf.shape)
    raise KeyError(f"no initializer for {jax.tree_util.keystr(path)}")


def draw_variables(shapes, seed: int) -> dict:
    """Variables of the given shapes (`jax.eval_shape` of an init: no
    compile, where a jitted init compiles the whole module, ~11 s for a
    composition at this size on the CPU) drawn from a seeded numpy stream
    as the JAX initializers draw them (`_draw`)."""
    rs = np.random.RandomState(seed)
    return dict(jax.tree_util.tree_map_with_path(
        lambda path, leaf: _draw(path, leaf, rs).astype(leaf.dtype), shapes))


def init_jax(module, *inputs, seed: int = 0):
    """`draw_variables` of the module's init, `perturb`ed."""
    key = jax.random.PRNGKey(seed)
    shapes = jax.eval_shape(lambda *xs: module.init(
        {"params": key, "noise": key, "dropout": key}, *xs, train=False), *inputs)
    return perturb(draw_variables(shapes, seed), seed + 5)


def images(batch: int = 2, seed: int = 0, channels: int = 3, size: int = SIZE):
    return np.random.RandomState(seed).uniform(-1, 1, (batch, size, size, channels)).astype(
        np.float32)


def wplus_pair(in_ch: int = 3, variant: int = 2):
    """(JAX, port) WPlusEncoder."""
    return (jenc.WPlusEncoder(SIZE, LATENT, in_ch, SCM, stylegan_variant=variant),
            tenc.WPlusEncoder(SIZE, LATENT, in_ch, SCM, stylegan_variant=variant))


@functools.lru_cache(maxsize=None)
def _jax_stylegan_autoencoder(seed: int):
    jmod = jae.StyleganAutoencoder(encoder=wplus_pair()[0], decoder=jax_decoder())
    return jmod, init_jax(jmod, jnp.zeros((1, SIZE, SIZE, 3)), seed=seed)


def stylegan_autoencoders(seed: int = 0):
    """(JAX StyleganAutoencoder, its variables, a fresh port copy in eval
    mode); the JAX side is built once per seed (the variables are numpy
    trees: callers must not change them in place)."""
    jmod, variables = _jax_stylegan_autoencoder(seed)
    tmod = load_port(tae.StyleganAutoencoder(wplus_pair()[1], port_decoder()), variables)
    return jmod, variables, tmod.eval()


def load_port(module, variables):
    """The JAX variables into a port composition (`load_autoencoder_state`:
    a decoder that only decoded w+ has no mapping-network parameters)."""
    from synthesis_in_style_tpu_torch.models.factory import load_autoencoder_state

    module.decoder.init_weights(torch.Generator().manual_seed(0))
    load_autoencoder_state(module, autoencoder_params_from_jax(variables))
    return module


def lpips_pair(net: str = "alex"):
    """(JAX LPIPS on its seeded random backbone, the port's LPIPS on the
    same backbone weights)."""
    import warnings

    from synthesis_in_style_tpu_torch.utils.checkpoint import (
        squeezenet_features_params_from_jax,
        vgg16_features_params_from_jax,
    )

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jl = JaxLPIPS(net=net)
    convert = {"alex": alexnet_features_params_from_jax, "vgg": vgg16_features_params_from_jax,
               "squeeze": squeezenet_features_params_from_jax}[net]
    tl = LPIPS(net=net, backbone_state=convert(numpy_tree(jl.variables["params"])))
    return jl, tl


def assert_close(got, ref, what, rel: float = 1e-4, scale=None):
    """max |got - ref| <= rel * (scale or max |ref|)."""
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    bound = rel * (float(np.max(np.abs(ref))) if scale is None else scale)
    assert err <= max(bound, 1e-30), (what, err, bound)
    return err


def assert_updates(after, before, want, keys, what, rel: float = 1e-2) -> float:
    """Each tensor's update (after - before) within rel of the largest
    reference update (want - before) over `keys`, which must be non-zero;
    returns that largest update. Every argument but `keys` is a state dict
    (`want` is the reference's, converted)."""
    keys = list(keys)
    assert keys, (what, "no tensors")
    scale = max(float((want[k] - before[k]).abs().max()) for k in keys)
    assert scale > 0, (what, "the reference did not move")
    for k in keys:
        assert_close(after[k] - before[k], (want[k] - before[k]).numpy(), f"{what} {k} update",
                     rel=rel, scale=scale)
    return scale


def snapshot(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def remove_files(*paths) -> None:
    """Delete a test's large files (snapshots of 512-channel networks run to
    hundreds of MB) once it has checked them: the temporary directories of
    recent test sessions are kept."""
    for path in paths:
        Path(path).unlink(missing_ok=True)


class SGD:
    """p <- p - lr * g over a parameter list (optax.sgd), with the port
    optimizers' `params` / `step(grads)` interface."""

    def __init__(self, params, lr: float):
        self.params = list(params)
        self.lr = lr

    @torch.no_grad()
    def step(self, grads):
        for p, g in zip(self.params, grads):
            if g is not None:
                p.sub_(self.lr * g)
