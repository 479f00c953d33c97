"""The port's mesh (micro_sam_tpu_torch/parallel) on the CPU against the JAX
package's (micro_sam_tpu/parallel) on tier-1's 8 virtual devices.

Three gloo worlds of CPU processes, each started once for the module (the
rank side is tests/torch_parallel_worlds.py): data = 2, model = 2, and
2 x 2 (the JAX package's ``model_axis=2``). Each world encodes, precomputes,
runs AMG, trains one SamTrainer epoch and one ``make_train_step`` step, one
epoch each of JointSamTrainer, MedSAMTrainer, SemanticSamTrainer and a LoRA
SamTrainer, draws SimpleSamTrainer's prompt kinds, encodes and differentiates
six PEFT / int4 encoders and predicts with a vit_t, on the weights of
``params_from_jax`` and seeded numpy inputs; the port's single process and
the JAX package (on its 4 x 2 mesh) run the same meanwhile, here. All
float32.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import optax
import torch_parallel_worlds as w
from torch_port_util import (jax_box_step_loss, jax_params, jax_step_loss, one_thread,
                             port_unetr, rel_err, tiny_jax_config, unetr_jax_params)

# optax transformation whose update is zero and whose state is the gradient
CAPTURE = optax.GradientTransformation(
    init=lambda p: jax.tree.map(jax.numpy.zeros_like, p),
    update=lambda g, s, p=None: (jax.tree.map(jax.numpy.zeros_like, g), g))

WORLDS = {"data2": (2, 1), "model2": (2, 2), "mesh2x2": (4, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def _port_cfg(cfg):
    from micro_sam_tpu_torch.models.sam import SamConfig
    return SamConfig(**{**dataclasses.asdict(cfg), "compute_dtype": "float32"})


def _port_state(cfg, params):
    from micro_sam_tpu_torch.models.convert import params_from_jax
    return params_from_jax(jax.tree.map(np.asarray, params), _port_cfg(cfg))


def _jax_references(sam256, sam128, tmp):
    """The JAX package's meshed results on the inputs of the worlds."""
    import optax
    from micro_sam_tpu.models.sam import Sam
    from micro_sam_tpu.parallel.embed import ShardedEncoder
    from micro_sam_tpu.parallel.mesh import make_mesh
    from micro_sam_tpu.parallel.train_step import make_train_step
    from micro_sam_tpu.predictor import SamPredictor
    from micro_sam_tpu.util import precompute_image_embeddings
    tp = make_mesh(jax.devices()[:8], model_axis=2)
    dp = make_mesh(jax.devices()[:8], model_axis=1)
    ref = {}
    enc = ShardedEncoder(sam256, mesh=tp)
    batch = w.encode_input()
    ref["encode"] = enc.encode_batch(batch)
    ref["encode_partial"] = enc.encode_batch(batch[:3])
    emb = precompute_image_embeddings(SamPredictor(sam256, mesh=tp), w.precompute_input(),
                                      tile_shape=(256, 256), halo=(32, 32), verbose=False,
                                      batch_size=4)
    ref["precompute"] = {t: np.asarray(e["features"]) for t, e in emb["features"].items()}
    ref["amg"], ref["amg_decode"] = _jax_amg(
        SamPredictor(Sam(sam256.config, sam256.params), mesh=dp), dp)

    ref["trainer"] = _jax_trainer_step(sam128, tp, tmp)

    optimizer = optax.adamw(1e-4)
    step = jax.jit(make_train_step(sam128, optimizer))
    pixels, points, labels_, targets = w.step_input(sam128.config)
    params, _, loss, _ = step(sam128.params, optimizer.init(sam128.params), pixels, points,
                              labels_.astype(np.int32), targets)
    ref["step"] = (float(loss), _port_state(sam128.config, params))
    return ref


def _jax_trainer_step(sam128, mesh, tmp):
    """The JAX package's loss and gradients of the trainer's first step (a
    point round, multimask, n_sub_iteration 1) over its mesh, the parameters
    split as its trainer splits them: ``jax_step_loss`` on the global batch
    the port's trainer prepares, with the port's prompts (the point and one
    padding point). The JAX trainer itself pads each object's prompts to a
    fixed capacity of label -1 tokens, which take part in the decoder's
    attention (tests/test_torch_training.py::test_padded_round0_diverges)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from micro_sam_tpu.parallel.mesh import sam_param_shardings
    from micro_sam_tpu_torch.training.sam_trainer import SamTrainer
    from micro_sam_tpu_torch.training.trainable_sam import TrainableSAM
    from micro_sam_tpu_torch.training.util import ConvertToSamInputs
    imgs, labels = w.trainer_data()
    trainer = SamTrainer(name="prep", train_loader=[], val_loader=[],
                         model=TrainableSAM(w.load_sam(w.CFG128, tmp / "sd128.pt", train=True)),
                         n_sub_iteration=1, n_objects_per_batch=2,
                         convert_inputs=ConvertToSamInputs(box_distortion_factor=0.025),
                         save_root=str(tmp / "prep"), seed=0, logger=False)
    batch = trainer._prepare_batch(imgs, labels, True, False, 1, 0)
    p_shard = sam_param_shardings(sam128.params, mesh)
    fn = jax.jit(jax.value_and_grad(jax_step_loss(sam128.config, sam128.params, batch, 1),
                                    has_aux=True),
                 in_shardings=(p_shard,), out_shardings=NamedSharding(mesh, P()))
    (loss, _), grads = fn(jax.device_put(sam128.params, p_shard))
    return float(loss), _port_state(sam128.config, grads)


def _jax_amg(predictor, mesh):
    """The JAX package's meshed AMG records, then its ShardedAmgDecoder over
    the AMG's grid (16 points, and 13: padding) on the image's embeddings."""
    from micro_sam_tpu.instance_segmentation import AutomaticMaskGenerator
    from micro_sam_tpu.ops.amg_utils import build_point_grid
    from micro_sam_tpu.parallel.decode import ShardedAmgDecoder
    from micro_sam_tpu.sample_data import synthetic_data
    from micro_sam_tpu.util import precompute_image_embeddings
    image, _ = synthetic_data(shape=(256, 256), seed=42)
    emb = precompute_image_embeddings(predictor, image, verbose=False)
    amg = AutomaticMaskGenerator(predictor, points_per_side=w.AMG_GRID,
                                 prefilter_thresholds=(-10.0, -10.0))
    amg.initialize(image, emb, verbose=False)
    records = amg.generate(pred_iou_thresh=0.0, stability_score_thresh=0.0,
                           output_mode="binary_mask")
    grid = (build_point_grid(w.AMG_GRID) * 256).astype(np.float32)
    dec = ShardedAmgDecoder(predictor, mesh=mesh)
    return ([(float(r["predicted_iou"]), np.asarray(r["segmentation"])) for r in records],
            [tuple(np.asarray(a) for a in dec(g)) for g in (grid, grid[:13])])


def _port_single(workdir):
    """The port's single process on the worlds' inputs."""
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.predictor import SamPredictor
    pred = SamPredictor(w.load_sam(w.CFG256, os.path.join(workdir, "sd256.pt")))
    emb = util.precompute_image_embeddings(pred, w.precompute_input(), tile_shape=(256, 256),
                                           halo=(32, 32), verbose=False, batch_size=4)
    imgs, labels = w.trainer_data()
    sd128 = os.path.join(workdir, "sd128.pt")
    root = os.path.join(workdir, "single")
    return {"precompute": {t: np.asarray(e["features"]) for t, e in emb["features"].items()},
            "trainer": w.trainer_run(w.CFG128, sd128, None, imgs, labels, root),
            "joint": w.joint_run(w.CFG128, sd128, os.path.join(workdir, "unetr.pt"), None, imgs,
                                 labels, w.distance_targets(labels), root),
            "instance": w.joint_run(w.CFG128, sd128, os.path.join(workdir, "unetr.pt"), None,
                                    imgs, labels, w.distance_targets(labels), root, frozen=True),
            "medsam": w.medsam_run(w.CFG128, sd128, None, imgs, labels, root),
            "semantic": w.semantic_run(w.CFG128, sd128, None, imgs, labels % 3, root),
            "simple_draws": w.simple_draws(None),
            "peft": w.peft_checks(None, workdir),
            "lora_trainer": w.lora_trainer_run(None, workdir, imgs, labels, root),
            "qlora_export": w.qlora_export_run(None, workdir, imgs, labels, root),
            "vit_t": w.vit_t_predict(None)}


def _peft_cfg():
    return dataclasses.replace(tiny_jax_config(128), embed_dim=w.CFG_PEFT["embed_dim"])


def _peft_trees():
    """The JAX package's PEFT encoders of ``PEFT_CASES`` (random PEFT leaves,
    test_torch_peft's ``_redraw``) and the port's state dicts of them."""
    from micro_sam_tpu.models.peft_sam import apply_peft as jax_apply_peft
    from micro_sam_tpu_torch.models.convert import params_from_jax
    from micro_sam_tpu_torch.models.peft_sam import apply_peft
    from micro_sam_tpu_torch.models.sam import Sam, SamConfig
    from test_torch_peft import _redraw
    cfg = _peft_cfg()
    pcfg = SamConfig(**w.CFG_PEFT)
    trees, states = {}, {}
    for i, (name, kw) in enumerate(w.PEFT_CASES.items()):
        tree = jax.tree.map(np.asarray, jax_apply_peft(jax_params(cfg, seed=11), cfg, **kw))
        trees[name] = _redraw(tree, np.random.RandomState(40 + i), name != "ssf_proj")
        sam = Sam(pcfg, torch.float32)
        apply_peft(sam, **kw)
        sam.load_state_dict(params_from_jax(trees[name], pcfg))
        states[name] = sam.state_dict()
    return trees, states


def _jax_derived_references(sam128, trees, tmp):
    """The JAX package's references of the derived trainers, the PEFT
    encoders and the LoRA trainer on its 4 x 2 mesh (model = 2), each on the
    global batch the port's single process prepares: the joint trainer's
    decoder step, MedSAMTrainer's box round, SemanticSamTrainer's step, every PEFT encoder's
    meshed encode (``ShardedEncoder``) and gradients, and the LoRA SAM's
    point round (``jax_step_loss``)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from micro_sam_tpu.models.sam import Sam
    from micro_sam_tpu.parallel.embed import ShardedEncoder
    from micro_sam_tpu.parallel.mesh import make_mesh, sam_param_shardings
    from micro_sam_tpu.training.joint_sam_trainer import JointSamTrainer as JT
    from micro_sam_tpu.training.semantic_sam_trainer import SemanticSamTrainer as JS
    from micro_sam_tpu.training.trainable_sam import TrainableSAM as JTS
    from micro_sam_tpu.training.util import value_and_grad_allow_int
    from micro_sam_tpu_torch.models.convert import params_from_jax, unetr_params_from_jax
    from micro_sam_tpu_torch.models.sam import SamConfig
    from micro_sam_tpu_torch.training.simple_sam_trainer import MedSAMTrainer
    from micro_sam_tpu_torch.training.trainable_sam import TrainableSAM
    from micro_sam_tpu_torch.training.util import ConvertToSamInputs
    mesh = make_mesh(jax.devices()[:8], model_axis=2)
    repl = NamedSharding(mesh, P())
    cfg128 = sam128.config
    imgs, labels = w.trainer_data()
    ref = {}

    def meshed_grad(loss_fn, params, has_aux=False):
        shard = sam_param_shardings(params, mesh)
        fn = jax.jit(value_and_grad_allow_int(loss_fn, has_aux=has_aux), in_shardings=(shard,),
                     out_shardings=repl)
        return fn(jax.device_put(params, shard))

    # the joint trainer's decoder step (the port's SAM optimizer has lr 0:
    # ``joint_run``)
    dec = torch.load(tmp / "unetr_jax.pt", weights_only=False)
    jt = JT("j", None, None, JTS(Sam(cfg128, sam128.params)),
            unetr=jax.tree.map(jnp.asarray, dec), logger=False)
    jt.unetr_optimizer = CAPTURE
    jt.unetr_opt_state = CAPTURE.init(jt.unetr_params)
    shard = sam_param_shardings(sam128.params, mesh)
    _, grads, loss = jt._build_unetr_step()(jt.unetr_params, jt.unetr_opt_state,
                                            jax.device_put(sam128.params, shard),
                                            jnp.asarray(imgs),
                                            jnp.asarray(w.distance_targets(labels)))
    ref["joint_decoder"] = (float(loss), {k: v.numpy() for k, v in unetr_params_from_jax(
        jax.tree.map(np.asarray, grads)).items()})
    # MedSAMTrainer's box round on the batch the port prepares
    prep = MedSAMTrainer(name="prep", train_loader=[], val_loader=[],
                         model=TrainableSAM(w.load_sam(w.CFG128, tmp / "sd128.pt", train=True)),
                         n_objects_per_batch=2, save_root=str(tmp / "prep"), seed=0, logger=False,
                         convert_inputs=ConvertToSamInputs(box_distortion_factor=0.025,
                                                           rng=np.random.RandomState(17)))
    batch = prep._prepare_batch(imgs, labels, False, True, 0, 0)
    loss, grads = meshed_grad(jax_box_step_loss(cfg128, sam128.params, batch), sam128.params)
    ref["medsam"] = (float(loss), _port_state(cfg128, grads))
    # SemanticSamTrainer's step
    js = JS("s", None, None, JTS(Sam(cfg128, sam128.params)), optimizer=CAPTURE, num_classes=3,
            logger=False)
    x, t = js.convert_inputs(imgs, labels % 3)
    params = jax.device_put(jax.tree.map(jnp.copy, sam128.params),
                            sam_param_shardings(sam128.params, mesh))
    _, grads, loss = js._build_semantic_step((128, 128))(params, CAPTURE.init(params), x, t)
    ref["semantic"] = (float(loss), _port_state(cfg128, grads))
    # the PEFT encoders: meshed encode and gradients of sum(embedding * w)
    cfg = _peft_cfg()
    pcfg = SamConfig(**w.CFG_PEFT)
    px, wt = w.peft_input()
    ref["peft"] = {}
    for name, tree in trees.items():
        if name == "ssf_proj":  # the JAX forward ignores proj's SSF terms
            continue
        params = jax.tree.map(jnp.asarray, tree)
        feats = ShardedEncoder(Sam(cfg, params), mesh=mesh).encode_batch(px)
        model = JTS(Sam(cfg, params))
        _, grads = meshed_grad(lambda p: jnp.sum(model.image_embeddings_oft(p, jnp.asarray(px))
                                                 * wt), params)
        grads = jax.tree.map(np.asarray, grads)
        ref["peft"][name] = (np.asarray(feats), {k: v.numpy() for k, v in params_from_jax(
            grads, pcfg).items() if v.dtype == torch.float32})
    # the LoRA SAM's point round on the batch the port's trainer prepares
    from micro_sam_tpu_torch.training.sam_trainer import SamTrainer
    lora = w.load_peft("lora_mlp", str(tmp)).train()
    prep = SamTrainer(name="prep", train_loader=[], val_loader=[], model=TrainableSAM(lora),
                      n_sub_iteration=1, n_objects_per_batch=2, save_root=str(tmp / "prep"),
                      seed=0, logger=False,
                      convert_inputs=ConvertToSamInputs(box_distortion_factor=0.025,
                                                        rng=np.random.RandomState(17)))
    batch = prep._prepare_batch(imgs, labels, True, False, 1, 0)
    params = jax.tree.map(jnp.asarray, trees["lora_mlp"])
    (loss, _), grads = meshed_grad(jax_step_loss(cfg, params, batch, 1), params, has_aux=True)
    ref["lora_trainer"] = (float(loss), {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, grads), pcfg).items() if v.dtype == torch.float32})
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start the three worlds on the port's random weights (seeds 0 and 1),
    compute the JAX and single-process references on the same weights while
    they run, then collect rank 0's results of each."""
    import jax.numpy as jnp
    from micro_sam_tpu.models.sam import Sam
    from micro_sam_tpu_torch.models.build_sam import make_sam
    from micro_sam_tpu_torch.models.convert import params_to_jax
    from micro_sam_tpu_torch.models.sam import SamConfig
    tmp = tmp_path_factory.mktemp("worlds")
    sams = {}
    for size, kw, seed in ((256, w.CFG256, 0), (128, w.CFG128, 1)):
        sams[size] = make_sam(SamConfig(**kw), None, seed, torch.float32)
        torch.save(sams[size].state_dict(), tmp / f"sd{size}.pt")
    dec = unetr_jax_params(True, seed=2)
    torch.save(dec, tmp / "unetr_jax.pt")
    torch.save(port_unetr(dec).state_dict(), tmp / "unetr.pt")
    trees, states = _peft_trees()
    for name, sd in states.items():
        torch.save(sd, tmp / f"peft_{name}.pt")
    procs = {name: w.start("run_world", n, m, str(tmp), name) for name, (n, m) in WORLDS.items()}
    try:
        jax_sams = [Sam(tiny_jax_config(size), jax.tree.map(jnp.asarray, params_to_jax(
            sams[size].state_dict(), sams[size].config))) for size in (256, 128)]
        ref = _jax_references(*jax_sams, tmp)
        single = _port_single(str(tmp))
        ref.update(_jax_derived_references(jax_sams[1], trees, tmp))
    finally:
        for p in procs.values():
            w.wait(p)
    return {name: torch.load(tmp / f"{name}.pt", weights_only=False) for name in WORLDS}, ref, \
        single


# ---------------------------------------------------------------------------
# the layout and the sharding rule, no processes
# ---------------------------------------------------------------------------

def test_mesh_layout_matches_jax():
    from micro_sam_tpu.parallel.mesh import make_mesh
    from micro_sam_tpu_torch.parallel.mesh import mesh_layout
    for m in (1, 2, 4):
        jmesh = make_mesh(jax.devices()[:8], model_axis=m)
        assert np.vectorize(lambda d: d.id)(jmesh.devices).tolist() == mesh_layout(8, m)
        assert dict(jmesh.shape) == {"data": 8 // m, "model": m}
    with pytest.raises(ValueError, match="divisible"):
        mesh_layout(6, 4)


def _jax_split(params, config):
    """{port state-dict key: dim} of every tensor the JAX rule splits, its
    (in, out) weights in the port's (out, in) layout: each JAX leaf is filled
    with its own number, so that the port's tensors tell where they came
    from."""
    from micro_sam_tpu.parallel.mesh import _spec_for_path
    from micro_sam_tpu_torch.models.convert import params_from_jax
    specs = {}

    def mark(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: mark(v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [mark(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
        specs[len(specs) + 1] = (prefix, tuple(_spec_for_path(prefix)))
        return np.full(tree.shape, len(specs), np.float32)

    sd = params_from_jax(mark(params), config)
    out = {}
    for key, v in sd.items():
        for leaf in np.unique(v.numpy()):
            path, spec = specs.get(int(leaf), ("", ()))
            if "model" in spec:
                dim = spec.index("model")
                out[key] = (1 - dim) if path.endswith("/w") else dim
    return out


def test_split_rule_matches_jax_vit_b():
    """Every tensor the port splits, and its dim, is the JAX rule's (the tiny vit_b)."""
    from micro_sam_tpu_torch.parallel.mesh import split_rule
    from micro_sam_tpu.models.sam import init_sam_params
    from micro_sam_tpu_torch.models.sam import Sam
    cfg = tiny_jax_config(256)
    params = jax.eval_shape(lambda: init_sam_params(jax.random.PRNGKey(0), cfg))
    sd = Sam(_port_cfg(cfg)).state_dict()
    port = {k: split_rule(k, _port_cfg(cfg))[0] for k in sd if split_rule(k, _port_cfg(cfg))}
    assert port == _jax_split(params, _port_cfg(cfg))
    assert len(port) == 6 * cfg.depth


def test_split_rule_vit_t_replicated():
    """vit_t stays whole over the model axis (its chains are not split), a
    divergence by design: the JAX rule splits its attention qkv / proj and
    MLP products."""
    import micro_sam_tpu.models.sam as jsam
    from micro_sam_tpu_torch.models.sam import SamConfig
    from micro_sam_tpu_torch.parallel.mesh import split_rule
    jcfg = jsam.SamConfig(model_type="vit_t", encoder="tiny_vit", img_size=256)
    params = jax.eval_shape(lambda: jsam.init_sam_params(jax.random.PRNGKey(0), jcfg))
    cfg = SamConfig(model_type="vit_t", encoder="tiny_vit", img_size=256)
    jax_split = _jax_split(params, cfg)
    assert jax_split  # the JAX rule splits vit_t's blocks
    assert all(split_rule(k, cfg) is None for k in jax_split)
    assert all(split_rule(k, tiny_jax_config(256)) is not None for k in
               ("image_encoder.blocks.0.attn.qkv.weight", "image_encoder.blocks.1.mlp.lin2.weight"))


def test_dice_loss_matches_jax():
    from micro_sam_tpu.parallel.train_step import dice_loss as jax_dice
    from micro_sam_tpu_torch.parallel.train_step import dice_loss
    rng = np.random.RandomState(5)
    logits = rng.randn(2, 3, 16, 16).astype(np.float32) * 3
    target = (rng.rand(2, 3, 16, 16) > 0.6).astype(np.float32)
    got = float(dice_loss(torch.from_numpy(logits), torch.from_numpy(target)))
    assert abs(got - float(jax_dice(logits, target))) < 1e-6


def test_shard_sam_refuses_what_does_not_split():
    from micro_sam_tpu_torch.models.build_sam import make_sam
    from micro_sam_tpu_torch.models.sam import SamConfig
    from micro_sam_tpu_torch.parallel.mesh import Mesh, shard_sam_
    mesh = Mesh({"data": 1, "model": 3}, 0, 1, None, None, None, torch.device("cpu"), [0], None)
    cfg = SamConfig(**{**w.CFG256, "num_heads": 3, "embed_dim": 96})
    sam = shard_sam_(make_sam(cfg, None, 0, torch.float32), mesh)
    blk = sam.image_encoder.blocks[0]
    assert tuple(blk.attn.qkv.weight.shape) == (96, 96) and blk.tp.size == 3
    assert tuple(blk.attn.proj.weight.shape) == (96, 32)
    assert tuple(blk.mlp.lin1.weight.shape) == (128, 96)
    with pytest.raises(ValueError, match="already"):
        shard_sam_(sam, mesh)
    with pytest.raises(ValueError, match="divide"):
        shard_sam_(make_sam(SamConfig(**w.CFG256), None, 0, torch.float32), mesh)
    lora = shard_sam_(make_sam(cfg, None, 0, torch.float32,
                               peft_kwargs={"rank": 2, "update_matrices": ("q", "v", "mlp")}),
                      mesh)
    blk = lora.image_encoder.blocks[0]
    assert tuple(blk.attn.lora["q"].a.shape) == (96, 2)        # read whole
    assert tuple(blk.attn.lora["q"].b.shape) == (2, 32)        # the shard's head
    assert tuple(blk.mlp.lin1.lora.b.shape) == (2, 128) and tuple(blk.mlp.lin1.lora.a.shape) == (96, 2)
    assert tuple(blk.mlp.lin2.lora.a.shape) == (128, 2) and tuple(blk.mlp.lin2.lora.b.shape) == (2, 96)
    mesh2 = Mesh({"data": 1, "model": 2}, 0, 1, None, None, None, torch.device("cpu"), [0], None)
    qlora = shard_sam_(make_sam(SamConfig(**w.CFG_PEFT), None, 0, torch.float32,
                                peft_kwargs={"rank": 2, "quantize": True}), mesh2)
    blk = qlora.image_encoder.blocks[0]
    assert tuple(blk.attn.qkv.w_q4.shape) == (192, 64) and tuple(blk.attn.qkv.w_scale.shape) == (2, 192)
    assert tuple(blk.attn.proj.w_q4.shape) == (128, 32) and tuple(blk.attn.proj.w_scale.shape) == (1, 128)
    with pytest.raises(ValueError, match="int4 blocks"):  # proj's 64 inputs in shards of 32
        shard_sam_(make_sam(SamConfig(**w.CFG128), None, 0, torch.float32,
                            peft_kwargs={"rank": 2, "quantize": True}), mesh2)


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(WORLDS))
def test_sharded_encoder_matches_jax(worlds, name):
    """encode_batch over the mesh (full batch, and a partial one: padding)
    against JAX's ShardedEncoder at model_axis=2, f32 atol 2e-4."""
    got, ref, _ = worlds
    n, m = WORLDS[name]
    assert got[name]["shape"] == {"data": n // m, "model": m}
    for key in ("encode", "encode_partial"):
        a, b = got[name][key], np.asarray(ref[key])
        assert a.shape == b.shape
        assert np.abs(a - b).max() < 2e-4, (key, np.abs(a - b).max())
    assert np.array_equal(got[name]["encode_tiles"], got[name]["encode_partial"])


@pytest.mark.parametrize("name", list(WORLDS))
def test_global_batch_and_replicate(worlds, name):
    """global_batch: the data ranks' shares in data-rank order; replicate:
    mesh rank 0's value, a tensor or an object."""
    got, _, _ = worlds
    n, m = WORLDS[name]
    share = np.arange(6, dtype=np.float32).reshape(3, 2)
    want = np.concatenate([share + 10 * i for i in range(n // m)])
    assert np.array_equal(got[name]["global_batch"], want)
    tensor, obj = got[name]["replicate"]
    assert np.array_equal(tensor, np.zeros(3, np.float32)) and obj == {"rank": 0}


@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_precompute_matches_jax_and_single(worlds, name):
    got, ref, single = worlds
    tiles = got[name]["precompute"]
    assert set(tiles) == set(ref["precompute"]) == set(single["precompute"])
    for t in tiles:
        assert np.abs(tiles[t] - ref["precompute"][t]).max() < 2e-4, t
        assert np.abs(tiles[t] - single["precompute"][t]).max() < 2e-4, t


@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_precompute_shares_one_cache(worlds, name):
    """One save_path for every rank: mesh rank 0 writes it, a second call is
    a cache hit and a lazy load reads it, the same tiles on every rank; one
    process loads it as the single process's cache."""
    from micro_sam_tpu_torch import util
    from micro_sam_tpu_torch.predictor import SamPredictor
    got, _, single = worlds
    verdicts, path = got[name]["shared_cache"]
    assert [v[0] for v in verdicts] == list(range(len(verdicts)))
    assert all(v[1] and v[2] == sorted(single["precompute"]) for v in verdicts)
    pred = SamPredictor(w.load_sam(w.CFG256, os.path.join(os.path.dirname(path), "sd256.pt")))
    emb = util.precompute_image_embeddings(pred, w.precompute_input(), save_path=path,
                                           tile_shape=(256, 256), halo=(32, 32), verbose=False)
    for t, e in single["precompute"].items():  # loaded, not recomputed: the meshed tiles
        assert np.array_equal(emb["features"][t]["features"], got[name]["precompute"][t])


@pytest.mark.parametrize("name", list(WORLDS))
def test_sharded_amg_decoder_matches_jax(worlds, name):
    """ShardedAmgDecoder against JAX's at test_sharded_amg_decode's bounds: the
    same shapes, under 1e-4 of the mask bits differing, IoU / stability /
    boxes within 5e-3; 13 points (padding) IoU within 2e-3."""
    got, ref, _ = worlds
    (full, part), (j_full, j_part) = got[name]["amg_decode"], ref["amg_decode"]
    for a, b in zip(full + part, j_full + j_part):
        assert a.shape == b.shape
    bits = np.unpackbits(full[0].reshape(-1)) != np.unpackbits(j_full[0].reshape(-1))
    assert bits.mean() < 1e-4
    for a, b in zip(full[1:], j_full[1:]):
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), atol=5e-3)
    np.testing.assert_allclose(part[1], j_part[1], atol=2e-3)


@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_amg_matches_jax(worlds, name):
    """test_production_amg_meshed_equals_single's bounds: the same records,
    IoU within 5e-3, masks differing on under 1e-3 of the pixels."""
    got, ref, _ = worlds
    a, b = got[name]["amg"], ref["amg"]
    assert len(a) == len(b) > 0
    for (iou_a, seg_a), (iou_b, seg_b) in zip(a, b):
        assert abs(iou_a - iou_b) < 5e-3
        assert (seg_a != seg_b).mean() < 1e-3


def _check_gradients(got, want, tol, zero=1e-7, looser=None):
    """Every gradient of ``want`` within rel ``tol`` of its tensor's max (the
    tensors named in ``looser`` within their own bound); a tensor whose
    gradient is zero by symmetry (a key bias shifts all logits of a query
    alike; ``zero`` of the largest gradient or less) is float noise on both
    sides, held below 1e-6 of the largest gradient
    (tests/test_torch_training.py). Fails naming every tensor out of bounds."""
    looser = looser or {}
    g_max = max(float(np.abs(g).max()) for g in want.values())
    checked, out = 0, {}
    for k, g in want.items():
        if float(np.abs(g).max()) <= zero * g_max:
            assert float(np.abs(got[k]).max()) <= 1e-6 * g_max, k
            continue
        if rel_err(got[k], g) > looser.get(k, tol):
            out[k] = rel_err(got[k], g)
        checked += 1
    assert not out, str(sorted(out.items()))  # every tensor out of bounds, unabridged
    return checked, g_max


@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_trainer_matches_single_process(worlds, name):
    """One SamTrainer epoch (n_sub_iteration 1) fed the data ranks' shares
    against the port's single process fed the global batch: losses and mean
    IoUs within 1e-5, the step's gradients within rel 1e-5 (``_check_gradients``),
    and the parameters after AdamW's first step within 1e-5 wherever the
    gradient decides the step. That step is lr * g / (|g| + eps) elementwise:
    where |g| is down at the rounding of the gradient's sums, its sign is the
    rounding's, and two orders of summation may move such an element by up to
    2 lr (checked for every element)."""
    got, _, single = worlds
    metrics, params, grads = got[name]["trainer"]
    s_metrics, s_params, s_grads = single["trainer"]
    for k in ("train_loss", "val_loss", "train_model_iou", "val_model_iou"):
        assert abs(metrics[0][k] - s_metrics[0][k]) < 1e-5, (k, metrics, s_metrics)
    assert set(grads) == set(s_grads)
    checked, g_max = _check_gradients(grads, s_grads, 1e-5)
    assert checked >= 100
    lr = 1e-5
    for k, g in s_grads.items():
        diff = np.abs(params[k] - s_params[k])
        if float(np.abs(g).max()) > 1e-7 * g_max:
            decided = np.abs(g) > 1e-3 * np.abs(g).max()
            assert diff[decided].max(initial=0) < 1e-5, k
        assert diff.max() <= 2.01 * lr, k
    for k in set(s_params) - set(s_grads):  # no gradient anywhere: untouched
        assert np.array_equal(params[k], s_params[k]), k


@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_trainer_matches_jax(worlds, name):
    """The step of that epoch against the JAX package's loss and gradients of
    the same step over its 4 x 2 mesh (``_jax_trainer_step``): loss rel 1e-5,
    gradients rel 1e-3 (tests/test_torch_training.py's bounds for one process)."""
    got, ref, _ = worlds
    metrics, _, grads = got[name]["trainer"]
    j_loss, j_grads = ref["trainer"]
    assert abs(metrics[0]["train_loss"] - j_loss) <= 1e-5 * abs(j_loss), (metrics, j_loss)
    checked, _ = _check_gradients(grads, {k: v.numpy() for k, v in j_grads.items()
                                          if k in grads}, 1e-3)
    assert checked >= 100


@pytest.mark.parametrize("name", list(WORLDS))
def test_train_step_matches_jax(worlds, name):
    """make_train_step's loss and one AdamW (1e-4) update over the mesh
    against JAX's make_train_step on the global batch, f32 1e-4."""
    got, ref, _ = worlds
    loss, params = got[name]["step"]
    j_loss, j_params = ref["step"]
    assert abs(loss - j_loss) < 1e-4, (loss, j_loss)
    for k, v in params.items():  # the port's parameters: its prompt PE matrix is a buffer
        assert np.abs(v - j_params[k].numpy()).max() < 1e-4, k


def test_trainer_batch_guard(worlds):
    """Shares of an odd global batch fail on every rank, in the JAX words."""
    got, _, _ = worlds
    for name in ("data2", "mesh2x2"):
        assert got[name]["guard"] is not None
        assert "Global batch size 3 must be divisible by the mesh data axis (2)" in \
            got[name]["guard"]


def test_dryruns_on_the_2x2_mesh(worlds):
    """dryrun_training_step and dryrun_production on the 2 x 2 world: a finite
    loss, the trainer's epoch, the meshed tiled precompute equal to the single
    process's within 1e-4 (asserted inside), a meshed predict."""
    got, _, _ = worlds
    step_loss, production = got["mesh2x2"]["dryrun"]
    assert np.isfinite(step_loss) and np.isfinite(production["trainer_loss"])
    assert production["precompute_err"] < 1e-4


def _hold_epoch(got, single, n_min):
    """An epoch's metrics (within 1e-5) and its step's gradients (within rel
    1e-5, ``_check_gradients``) against the single process's."""
    (metrics, grads), (s_metrics, s_grads) = got, single
    for a, b in zip(metrics, s_metrics):
        for k in b:
            assert abs(a[k] - b[k]) < 1e-5, (k, metrics, s_metrics)
    assert set(grads) == set(s_grads)
    checked, _ = _check_gradients(grads, s_grads, 1e-5)
    assert checked >= n_min


#: a decoder gradient at or below this share of the largest is zero in exact
#: arithmetic (an upsampler's bias ahead of a ConvBlock's InstanceNorm), as in
#: tests/test_torch_joint_training.py::_grads_held
DECODER_ZERO = 1e-6
#: the decoder's gradients against the single process: rel 1e-5, as the
#: SAM's; but the leaves of the two transposed-convolution blocks nearest the
#: encoder (``DECODER_LOOSE``) at rel 1e-4. Their gradients cancel, and on a
#: model axis the encoder's split float32 sums move the features the decoder
#: reads by their rounding, which these leaves amplify: this test reads them
#: at rel 1.0e-5 to 3.4e-5 from one process in the model = 2 and 2 x 2 worlds
#: (at data = 2 every leaf is within 1e-5), and every other leaf within 1e-5
DECODER_TOL = 1e-5
DECODER_LOOSE = {k: 1e-4 for k in (
    "deconv1.block.0.block.weight", "deconv1.block.0.block.bias",
    "deconv1.block.1.block.weight", "deconv1.block.1.block.bias", "deconv1.block.2.weight",
    "deconv2.block.0.block.weight", "deconv2.block.1.block.weight")}


def _hold_jax(loss, grads, ref, n_min, zero=1e-7):
    """A step's loss (rel 1e-5) and gradients (rel 1e-3) against the JAX
    package's ``(loss, gradients)``, on the port's keys."""
    j_loss, j_grads = ref
    assert abs(loss - j_loss) <= 1e-5 * abs(j_loss), (loss, j_loss)
    checked, _ = _check_gradients(grads, {k: np.asarray(v) for k, v in j_grads.items()
                                          if k in grads}, 1e-3, zero)
    assert checked >= n_min


@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_joint_trainer_matches_single_process(worlds, name):
    """One JointSamTrainer epoch fed the data ranks' shares (the SAM's AdamW
    at lr 0: ``joint_run``): the SAM step as SamTrainer's, the decoder
    step's loss within 1e-5 and its gradients within rel ``DECODER_TOL``
    (``DECODER_LOOSE`` for the named leaves) of the single process's on the
    global batch, the decoder after
    its AdamW step within 1e-5 where the gradient decides the step (and
    within 2 lr everywhere: ``test_meshed_trainer_matches_single_process``);
    every rank's checkpoint reloads the trained SAM and decoder (checked on
    the ranks)."""
    got, _, single = worlds
    metrics, inst, grads, dec_grads, dec = got[name]["joint"]
    s_metrics, s_inst, s_grads, s_dec_grads, s_dec = single["joint"]
    _hold_epoch((metrics, grads), (s_metrics, s_grads), 100)
    assert len(inst) == len(s_inst) == 1 and abs(inst[0] - s_inst[0]) < 1e-5 * abs(s_inst[0])
    checked, g_max = _check_gradients(dec_grads, s_dec_grads, DECODER_TOL, DECODER_ZERO,
                                  DECODER_LOOSE)
    assert checked >= 30
    for k, g in s_dec_grads.items():
        diff = np.abs(dec[k] - s_dec[k])
        decided = np.abs(g) > 1e-3 * np.abs(g).max()
        assert diff[decided].max(initial=0) < 1e-5 and diff.max() <= 2.01e-5, k


@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_joint_trainer_matches_jax(worlds, name):
    """The joint epoch's SAM step against the JAX package's step on its mesh
    (``_jax_trainer_step``), its decoder step against the JAX joint trainer's
    decoder step on the global batch over its 4 x 2 mesh: loss rel 1e-5,
    gradients rel 1e-3."""
    got, ref, _ = worlds
    metrics, inst, grads, dec_grads, _ = got[name]["joint"]
    _hold_jax(metrics[0]["train_loss"], grads, ref["trainer"], 100)
    _hold_jax(inst[0], dec_grads, ref["joint_decoder"], 30, DECODER_ZERO)


@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_instance_segmentation_training_matches_single_and_jax(worlds, name):
    """``train_instance_segmentation``'s trainer on the mesh: the joint
    trainer with the SAM frozen (no SAM optimizer; unchanged, checked on the
    ranks) trains the decoder as one process does (loss 1e-5, gradients
    ``DECODER_TOL``) and as the JAX joint trainer's decoder step (loss rel
    1e-5, gradients rel 1e-3)."""
    got, ref, single = worlds
    _, inst, grads, dec_grads, _ = got[name]["instance"]
    _, s_inst, _, s_dec_grads, _ = single["instance"]
    assert grads == {} and abs(inst[0] - s_inst[0]) < 1e-5 * abs(s_inst[0])
    checked, _ = _check_gradients(dec_grads, s_dec_grads, DECODER_TOL, DECODER_ZERO,
                                  DECODER_LOOSE)
    assert checked >= 30
    _hold_jax(inst[0], dec_grads, ref["joint_decoder"], 30, DECODER_ZERO)


@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_medsam_trainer_matches_single_and_jax(worlds, name):
    """One MedSAMTrainer epoch (a box round) against the single process
    (1e-5) and the JAX package's box round on its mesh (loss rel 1e-5,
    gradients rel 1e-3)."""
    got, ref, single = worlds
    metrics, grads = got[name]["medsam"]
    _hold_epoch(got[name]["medsam"], single["medsam"], 100)
    _hold_jax(metrics[0]["train_loss"], grads, ref["medsam"], 100)


@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_semantic_trainer_matches_single_and_jax(worlds, name):
    """One SemanticSamTrainer epoch (dice + cross-entropy of the promptless
    decode) against the single process (1e-5) and the JAX package's semantic
    step on its mesh (loss rel 1e-5, gradients rel 1e-3)."""
    got, ref, single = worlds
    metrics, grads = got[name]["semantic"]
    _hold_epoch(got[name]["semantic"], single["semantic"], 100)
    _hold_jax(metrics[0]["train_loss"], grads, ref["semantic"], 100)


@pytest.mark.parametrize("name", list(WORLDS))
def test_simple_trainer_draws_once_for_the_mesh(worlds, name):
    """SimpleSamTrainer's prompt kind is mesh rank 0's draw on every rank:
    with the ranks' ``random`` seeded apart, the mesh takes the branches of
    one process seeded like rank 0."""
    got, _, single = worlds
    assert got[name]["simple_draws"] == single["simple_draws"]
    assert len(set(single["simple_draws"])) == 2


@pytest.mark.parametrize("case", list(w.PEFT_CASES))
@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_peft_encoder_matches_single_and_jax(worlds, name, case):
    """A PEFT / int4 encoder split over the mesh: its encode within f32 rel
    1e-5 of the single process's and rel 1e-3 of the JAX package's meshed
    ``ShardedEncoder`` (not for ``ssf_proj``: JAX ignores proj's SSF); the
    gradients of sum(embedding * w) within rel 1e-5 of the single process's
    and rel 1e-3 of JAX's; the gathered state dict the single process's
    keys and values."""
    got, ref, single = worlds
    run, s_run = got[name]["peft"][case], single["peft"][case]
    assert rel_err(run["encode"], s_run["encode"]) <= 1e-5
    assert set(run["grads"]) == set(s_run["grads"])
    checked, _ = _check_gradients(run["grads"], s_run["grads"], 1e-5)
    assert checked >= 20
    assert set(run["state"]) == set(s_run["state"])
    assert all(torch.equal(v, s_run["state"][k]) for k, v in run["state"].items())
    if case in ref["peft"]:
        feats, j_grads = ref["peft"][case]
        assert rel_err(run["encode"], feats) <= 1e-3
        checked, _ = _check_gradients(run["grads"], {  # JAX ignores proj's SSF
            k: v for k, v in j_grads.items() if k in run["grads"] and "proj.ssf" not in k}, 1e-3)
        assert checked >= 20


@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_lora_trainer_matches_single_and_jax(worlds, name):
    """A LoRA SamTrainer epoch on the mesh trains what one process trains
    (the PEFT parameters, the prompt encoder and the mask decoder; the base
    encoder stays frozen, checked on the ranks), its epoch within 1e-5 of the
    single process's and its step within the JAX package's bounds."""
    got, ref, single = worlds
    metrics, grads, trained = got[name]["lora_trainer"]
    s_metrics, s_grads, s_trained = single["lora_trainer"]
    assert trained == s_trained and any(".lora." in k for k in trained)
    assert not any(k.startswith("image_encoder.") and k.endswith((".qkv.weight", ".lin1.weight"))
                   for k in trained)
    _hold_epoch((metrics, grads), (s_metrics, s_grads), 60)
    _hold_jax(metrics[0]["train_loss"], grads, ref["lora_trainer"], 60)


@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_qlora_checkpoint_exports_as_one_process(worlds, name):
    """A QLoRA SamTrainer on the mesh (the int4 base split, AdamW at lr 0)
    writes a checkpoint, gathered by mesh rank 0, that
    ``export_custom_qlora_model`` turns into the single process's export:
    the same keys, every value bitwise."""
    got, _, single = worlds
    a, b = got[name]["qlora_export"], single["qlora_export"]
    assert set(a) == set(b) and any(k.endswith("/lora/q/b") for k in a)
    assert all(np.array_equal(v, b[k]) for k, v in a.items())


@pytest.mark.parametrize("name", list(WORLDS))
def test_meshed_vit_t_predict_matches_single(worlds, name):
    """vit_t (whole on the model axis) predicts through a meshed predictor as
    one process does, within the bounds of the JAX package's
    ``test_production_vit_t_meshed_equals_single``: IoU predictions within
    2e-4, masks equal on more than 0.999 of the pixels."""
    got, _, single = worlds
    (masks, ious), (s_masks, s_ious) = got[name]["vit_t"], single["vit_t"]
    assert np.allclose(ious, s_ious, atol=2e-4)
    assert masks.shape == s_masks.shape and (masks == s_masks).mean() > 0.999
