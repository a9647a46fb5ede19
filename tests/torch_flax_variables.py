"""Port weights -> the JAX reference's flax variables, for the tests.

``to_flax_variables`` is the inverse of
``eov_tpu_torch.models.resnet.from_jax_variables``: a torchvision-named
state_dict becomes ``{"params", "batch_stats"}`` (OIHW -> HWIO, torchvision
names -> flax names), so a test can give the reference seeded weights
without flax's ``init`` (slow on the CPU for ResNet-50).
"""

import jax
import jax.numpy as jnp


def to_flax_variables(sd):
    """A torchvision-named state_dict -> the reference's {params,
    batch_stats} (the inverse of ``from_jax_variables``)."""
    params, stats = {}, {}

    def node(tree, path):
        for p in path:
            tree = tree.setdefault(p, {})
        return tree

    for k, v in sd.items():
        v = v.numpy()
        *mod, leaf = k.split(".")
        if mod[0].startswith("layer"):
            mod = [f"{mod[0]}_{mod[1]}"] + mod[2:]
        name = {"downsample.0": "downsample_conv",
                "downsample.1": "downsample_bn"}.get(".".join(mod[1:]))
        mod = mod[:1] + [name] if name else mod
        if mod[-1].startswith("conv") or mod[-1] == "downsample_conv":
            node(params, mod)["kernel"] = v.transpose(2, 3, 1, 0)
        elif mod == ["fc"]:
            node(params, mod)["kernel" if leaf == "weight" else "bias"] = (
                v.T if leaf == "weight" else v)
        else:  # a BatchNorm
            tree, key = {"weight": (params, "scale"), "bias": (params, "bias"),
                         "running_mean": (stats, "mean"),
                         "running_var": (stats, "var")}[leaf]
            node(tree, mod)[key] = v
    return jax.tree.map(jnp.asarray, {"params": params, "batch_stats": stats})
