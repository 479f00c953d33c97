"""SAM finetuning on the card (counterpart of ``micro_sam_tpu.training``)."""
from .joint_sam_trainer import JointSamLogger, JointSamTrainer
from .sam_trainer import SamLogger, SamTrainer
from .semantic_sam_trainer import CustomDiceLoss, SemanticMapsSamTrainer, SemanticSamTrainer
from .simple_sam_trainer import MedSAMTrainer, SimpleSamTrainer
from .trainable_sam import TrainableSAM
from .training import (CONFIGURATIONS, MinInstanceSampler, PerObjectDistanceTransform,
                       SamDataset, SamLoader, default_sam_dataset, default_sam_loader,
                       export_instance_segmentation_model, train_instance_segmentation,
                       train_sam, train_sam_for_configuration)
from .util import (ConvertToSamInputs, ConvertToSemanticSamInputs, ResizeLabelTrafo,
                   ResizeRawTrafo, get_raw_transform, get_trainable_sam_model, identity)

__all__ = ["SamTrainer", "SamLogger", "JointSamTrainer", "JointSamLogger", "CustomDiceLoss",
           "SemanticSamTrainer", "SemanticMapsSamTrainer", "SimpleSamTrainer", "MedSAMTrainer",
           "TrainableSAM", "SamDataset", "SamLoader", "MinInstanceSampler",
           "PerObjectDistanceTransform", "default_sam_dataset", "default_sam_loader",
           "CONFIGURATIONS", "train_sam", "train_sam_for_configuration",
           "train_instance_segmentation", "export_instance_segmentation_model",
           "ConvertToSamInputs", "ConvertToSemanticSamInputs", "ResizeRawTrafo",
           "ResizeLabelTrafo", "get_raw_transform", "get_trainable_sam_model", "identity"]
