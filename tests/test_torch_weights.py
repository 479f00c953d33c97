"""Weights of the port: ``params_from_jax`` against the JAX package's own
torch-layout export, the JAX native checkpoint, and a zoo-layout ``.pt``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_util import jax_params, tiny_jax_config


def _configs():
    from tests.make_golden import build_config
    return {"tiny": tiny_jax_config(), "vit_b224": build_config()}


@pytest.mark.parametrize("name", ["tiny", "vit_b224"])
def test_params_from_jax_equals_export_torch_state_dict(name):
    from micro_sam_tpu.models.convert import export_torch_state_dict
    from micro_sam_tpu.models.sam import init_sam_params
    from micro_sam_tpu_torch.models.convert import params_from_jax
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    cfg = _configs()[name]
    params = jax.tree.map(np.asarray, init_sam_params(jax.random.PRNGKey(0), cfg))
    ref = export_torch_state_dict(params, cfg)
    pcfg = SamConfig(**dataclasses.asdict(cfg))
    got = params_from_jax(params, pcfg)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the port's module has exactly this key layout
    module_sd = Sam(pcfg).state_dict()
    assert sorted(module_sd) == sorted(ref)
    assert all(tuple(module_sd[k].shape) == ref[k].shape for k in ref)


def test_native_checkpoint_loads(tmp_path):
    """The JAX package's native checkpoint (flat npz of tree paths)."""
    from micro_sam_tpu.util import save_native_checkpoint
    from micro_sam_tpu_torch.models.convert import load_native_checkpoint, params_from_jax
    from micro_sam_tpu_torch.models.sam import SamConfig
    cfg = tiny_jax_config()
    params = jax_params(cfg)
    path = str(tmp_path / "tiny.npz")
    save_native_checkpoint(path, params, cfg)
    pcfg = SamConfig(**dataclasses.asdict(cfg))
    _, sd = load_native_checkpoint(path, config=pcfg)
    ref = params_from_jax(jax.tree.map(np.asarray, params), pcfg)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)


def test_zoo_checkpoint_loads_through_get_sam_model(tmp_path):
    """A micro-sam training checkpoint: ``model_state`` with the ``sam.`` prefix."""
    from micro_sam_tpu_torch.util import get_sam_model
    src = get_sam_model("vit_b", device="cpu", seed=5)
    sd = src.model.state_dict()
    path = str(tmp_path / "vit_b.pt")
    torch.save({"model_state": {f"sam.{k}": v for k, v in sd.items()}}, path)
    p = get_sam_model("vit_b", device="cpu", checkpoint_path=path)
    got = p.model.state_dict()
    assert sorted(got) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)
    assert p._hash.startswith("sha256:")
