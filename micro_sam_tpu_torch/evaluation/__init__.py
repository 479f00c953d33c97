"""Evaluation of SAM models: matching metrics, prompt-based and iterative
inference, the grid searches of automatic segmentation, the benchmark and
LIVECell runners and the model comparison (the JAX package's
``evaluation`` API). Libraries that only some functions need (pandas,
imageio, h5py, matplotlib) are imported at the call."""
from .evaluation import run_evaluation, run_evaluation_for_iterative_prompting
from .inference import (
    run_inference_with_prompts, get_predictions_with_iterative_prompting,
    run_inference_with_iterative_prompting, run_amg, run_apg,
    run_instance_segmentation_with_decoder, precompute_all_embeddings,
    precompute_all_prompts,
)
from .instance_segmentation import (
    run_instance_segmentation_grid_search,
    run_instance_segmentation_inference,
    run_instance_segmentation_grid_search_and_inference,
    default_grid_search_values_amg,
    default_grid_search_values_instance_segmentation_with_decoder,
    evaluate_instance_segmentation_grid_search,
)
from . import experiments
from .matching import matching, mean_segmentation_accuracy
from . import livecell
from . import model_comparison
from . import multi_dimensional_segmentation
from . import benchmark_datasets
