"""Shared set-up of the parity tests between anatomask_tpu (JAX) and
anatomask_torch: the tiny SparK configuration, JAX parameters made from a seed
and moved into the port, and layout helpers. Everything runs on the CPU in
float32."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from anatomask_tpu.ssl.pretrain import PretrainConfig as JaxPretrainConfig
from anatomask_tpu.ssl.pretrain import build_spark_model as jax_build_spark_model
from anatomask_torch.convert import spark_state_dict_from_jax
from anatomask_torch.ssl.pretrain import PretrainConfig, build_spark_model

DIMS = (4, 8, 16, 32, 64)
PATCH = (32, 32, 32)
BATCH = 2


def tiny_configs(dims=DIMS, patch=PATCH):
    """The JAX and the port's config; the decoder is as wide as dims[-1]."""
    kw = dict(patch_size=patch, compute_dtype="float32", encoder_dims=dims)
    return (JaxPretrainConfig(method="anatomask", model_size="B", batch_size=BATCH,
                              mask_ratio=0.6, **kw),
            PretrainConfig(**kw))


def jax_params(model, seed: int):
    """Flax init, then every leaf moved by seeded noise so that biases, norm
    affines and mask tokens carry signal too."""
    key = jax.random.PRNGKey(seed)
    x0 = jnp.zeros((1, *model.input_size, 1), jnp.float32)
    # jitted: flax's eager init compiles op by op (minutes for a SparK)
    params = jax.jit(model.init)(key, x0, model.mask(key, 1))["params"]
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32)
        + 0.05 * rs.standard_normal(v.shape).astype(np.float32), params)


def port_model(params, cfg):
    model = build_spark_model(cfg, device="cpu")
    model.load_state_dict(spark_state_dict_from_jax(params), strict=True)
    return model


def to_ncdhw(a: np.ndarray) -> torch.Tensor:
    """NDHWC numpy -> NCDHW tensor in channels_last_3d memory."""
    t = torch.from_numpy(np.ascontiguousarray(a)).permute(0, 4, 1, 2, 3)
    return t.contiguous(memory_format=torch.channels_last_3d)


def mask_nd(keep: np.ndarray) -> jnp.ndarray:
    """(B, f1, f2, f3) bool -> the JAX mask (B, f1, f2, f3, 1)."""
    return jnp.asarray(keep[..., None])


def mask_port(keep: np.ndarray) -> torch.Tensor:
    """(B, f1, f2, f3) bool -> the port's mask (B, 1, f1, f2, f3)."""
    return torch.from_numpy(np.ascontiguousarray(keep[:, None]))


def random_keep(rs: np.random.RandomState, batch: int, fmap, len_keep: int) -> np.ndarray:
    L = int(np.prod(fmap))
    keep = np.zeros((batch, L), bool)
    for b in range(batch):
        keep[b, rs.permutation(L)[:len_keep]] = True
    return keep.reshape(batch, *fmap)



def numpy_params(module, seed: int, *init_args):
    """Parameters of a flax module called on `init_args`, drawn with numpy
    from a seed without running flax's (slow, eager) initialisation: kernels
    He-normal, norm scales 1 + noise, the rest noise."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *init_args))["params"]
    rs = np.random.RandomState(seed)

    def leaf(path, v):
        name = path[-1].key
        noise = rs.standard_normal(v.shape).astype(np.float32)
        if name == "kernel":
            return noise * np.float32(np.sqrt(2.0 / np.prod(v.shape[:-1])))
        return (1.0 + 0.1 * noise) if name == "scale" else 0.1 * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_random_params(module, input_shape, seed: int, *init_args):
    """numpy_params of a module whose first input is zeros of input_shape."""
    return numpy_params(module, seed, jnp.zeros(input_shape), *init_args)
