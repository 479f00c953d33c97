"""SAM finetuning on the card (counterpart of ``micro_sam_tpu.training``)."""
from .sam_trainer import SamTrainer
from .trainable_sam import TrainableSAM
from .training import SamDataset, SamLoader, MinInstanceSampler, train_sam
from .util import ConvertToSamInputs, get_trainable_sam_model

__all__ = ["SamTrainer", "TrainableSAM", "SamDataset", "SamLoader", "MinInstanceSampler",
           "train_sam", "ConvertToSamInputs", "get_trainable_sam_model"]
