"""The SA50 gate of finetuning at other initial-weight seeds, in either
package, on the CPU: tells a fault of the port's trainer from seed noise.

    JAX_PLATFORMS=cpu python tests/sa50_seed_study.py port 1 out.json
    JAX_PLATFORMS=cpu python tests/sa50_seed_study.py jax 1 out.json

``port`` runs ``test_torch_training_quality.sa50_gate`` with the initial
weights drawn from ``torch.Generator().manual_seed(seed)``; ``jax`` runs the
JAX package's gate (``tests/test_training.py::test_training_quality_threshold``)
with ``init_sam_params(PRNGKey(seed))``. Data, schedule, epochs and the
held-out images are the gates' own. Writes {"package", "seed", "sa50",
"msa", "seconds"} (SA50 and mSA per iteration; mSA null for JAX) to the
output path.
"""
import glob
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

S = 128


def port_gate(seed, root):
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_training_quality import sa50_gate
    torch.set_num_threads(1)
    sa50, msa, seconds = sa50_gate(torch.device("cpu"), root, seed=seed)
    return sa50, msa, seconds


def jax_gate(seed, root):
    """The body of the JAX package's gate, its weights from PRNGKey(seed)."""
    import imageio.v3 as imageio
    import jax
    import optax
    from micro_sam_tpu.evaluation.evaluation import run_evaluation
    from micro_sam_tpu.evaluation.inference import run_inference_with_iterative_prompting
    from micro_sam_tpu.models.sam import Sam, SamConfig, init_sam_params
    from micro_sam_tpu.sample_data import synthetic_data
    from micro_sam_tpu.training.sam_trainer import SamTrainer
    from micro_sam_tpu.training.trainable_sam import TrainableSAM
    from micro_sam_tpu.training.training import (default_sam_loader,
                                                 export_instance_segmentation_model)
    from micro_sam_tpu.util import get_sam_model
    cfg = SamConfig(model_type="vit_b", embed_dim=96, depth=2, num_heads=2,
                    global_attn_indexes=(1,), img_size=S, window_size=8)
    model = TrainableSAM(Sam(cfg, init_sam_params(jax.random.PRNGKey(seed), cfg)))
    train = [synthetic_data(shape=(S, S), seed=i, n_objects=6) for i in range(8)]
    loader = default_sam_loader(raw_paths=[im for im, _ in train], raw_key=None,
                                label_paths=[seg for _, seg in train], label_key=None,
                                patch_shape=(S, S), with_segmentation_decoder=False,
                                batch_size=1, n_samples=24)
    val_im, val_seg = synthetic_data(shape=(S, S), seed=100, n_objects=6)
    val_loader = default_sam_loader(raw_paths=[val_im], raw_key=None, label_paths=[val_seg],
                                    label_key=None, patch_shape=(S, S),
                                    with_segmentation_decoder=False, batch_size=1, n_samples=2)
    trainer = SamTrainer(name="quality", train_loader=loader, val_loader=val_loader, model=model,
                         optimizer=optax.adamw(optax.warmup_cosine_decay_schedule(
                             0.0, 6e-4, 100, 1500, 1e-5)),
                         n_sub_iteration=3, n_objects_per_batch=4, save_root=str(root),
                         mask_prob=0.5)
    t0 = time.perf_counter()
    trainer.fit(epochs=60, verbose=False)
    seconds = time.perf_counter() - t0
    exported = root / "exported.pkl"
    export_instance_segmentation_model(str(root / "quality" / "best.pkl"), str(exported))
    predictor = get_sam_model(checkpoint_path=str(exported))
    data_dir = root / "test-data"
    data_dir.mkdir()
    image_paths, label_paths = [], []
    for i in range(2):
        im, seg = synthetic_data(shape=(S, S), seed=200 + i, n_objects=6)
        ip, lp = str(data_dir / f"im{i}.tif"), str(data_dir / f"gt{i}.tif")
        imageio.imwrite(ip, im)
        imageio.imwrite(lp, seg)
        image_paths.append(ip)
        label_paths.append(lp)
    pred_dir = str(root / "predictions")
    run_inference_with_iterative_prompting(predictor, image_paths, label_paths,
                                           embedding_dir=None, prediction_dir=pred_dir,
                                           start_with_box_prompt=False, n_iterations=3)
    sa50 = []
    for it in range(3):
        preds = sorted(glob.glob(os.path.join(pred_dir, f"iteration{it:02}", "*.tif")))
        sa50.append(float(run_evaluation(label_paths, preds, verbose=False)["SA50"].values.item()))
    return sa50, None, seconds


def main(package, seed, out):
    with tempfile.TemporaryDirectory() as tmp:
        gate = port_gate if package == "port" else jax_gate
        sa50, msa, seconds = gate(int(seed), Path(tmp))
    result = {"package": package, "seed": int(seed), "sa50": sa50, "msa": msa,
              "seconds": seconds}
    with open(out, "w") as f:
        json.dump(result, f)
    print(json.dumps(result))


if __name__ == "__main__":
    main(*sys.argv[1:4])
