"""Helpers of the port's parity tests: JAX parameter trees drawn with numpy."""
import jax
import numpy as np


def numpy_params(model, seed):
    """A JAX parameter tree of ``model`` drawn with numpy from ``seed``
    (shapes from ``jax.eval_shape``; the JAX ResDeconv's own init compiles
    for seconds): conv weights He-normal, norm scales near 1, biases and
    other leaves near 0, float32 numpy."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "w":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.normal(size=leaf.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)
