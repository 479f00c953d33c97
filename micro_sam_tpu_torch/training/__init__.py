"""SAM finetuning on the card (counterpart of ``micro_sam_tpu.training``)."""
from .sam_trainer import SamTrainer
from .trainable_sam import TrainableSAM
from .training import (CONFIGURATIONS, MinInstanceSampler, SamDataset, SamLoader,
                       default_sam_dataset, default_sam_loader, train_sam,
                       train_sam_for_configuration)
from .util import ConvertToSamInputs, get_trainable_sam_model

__all__ = ["SamTrainer", "TrainableSAM", "SamDataset", "SamLoader", "MinInstanceSampler",
           "default_sam_dataset", "default_sam_loader", "CONFIGURATIONS", "train_sam",
           "train_sam_for_configuration", "ConvertToSamInputs", "get_trainable_sam_model"]
