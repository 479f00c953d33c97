"""The training widget (counterpart of ``micro_sam_tpu/sam_annotator/training_ui.py``).

It wraps the port's ``train_sam_for_configuration`` and the export helper, on
the form layer of ``_compat`` (Qt under napari, plain Python headless), so the
whole callback path (validate -> loaders -> train -> export) runs without a
display. Its default configuration is ``_find_best_configuration``'s: "A100"
where a GPU is present, else "CPU".
"""
from __future__ import annotations

import os
import warnings

from .. import util
from ..training import CONFIGURATIONS, train_sam_for_configuration
from ..training.training import (
    _export_helper, _find_best_configuration, default_sam_loader,
)
from ._compat import FormWidget, generate_message
from ._widgets import _ModelSelectionMixin


class TrainingWidget(_ModelSelectionMixin, FormWidget):
    """Finetune a SAM model from the annotation tool (micro-sam's
    training_ui.py:18)."""

    def __init__(self, parent=None):
        super().__init__(parent)
        # general options
        self._add_path_param("raw_path", None, "both", title="Path to images",
                             placeholder="/path/to/images")
        self._add_string_param("raw_key", None, title="Image data key",
                               placeholder='e.g. "*.tif"')
        self._add_path_param("label_path", None, "both", title="Path to labels",
                             placeholder="/path/to/labels")
        self._add_string_param("label_key", None, title="Label data key",
                               placeholder='e.g. "*.tif"')
        self._add_choice_param("configuration", _find_best_configuration(),
                               list(CONFIGURATIONS.keys()), title="Configuration")
        self._add_bool_param("with_segmentation_decoder", True,
                             title="With segmentation decoder")
        # advanced settings
        self._add_choice_param("device", "auto", ["auto"] + util._available_devices(),
                               title="Device")
        self._add_shape_param(("patch_x", "patch_y"), (512, 512), min_val=0,
                              max_val=2048, title=("Patch size x", "Patch size y"))
        self._add_path_param("raw_path_val", None, "both",
                             title="Path to validation images")
        self._add_path_param("label_path_val", None, "both",
                             title="Path to validation labels")
        self._add_string_param("name", "sam_model", title="Name of Trained Model")
        self._init_model_selection("vit_b")
        self._add_string_param("custom_weights", None, title="Custom Weights")
        self._add_string_param("output_path", None, title="Output Path")
        self._add_int_param("n_epochs", 100, min_val=1, max_val=1000,
                            title="Number of epochs")
        self.run_button = self._add_button("run", "Start Training", self.__call__)

    # ------------------------------------------------------------------
    def _get_loaders(self):
        """Build train/val loaders; without explicit val paths, split off 10%
        (at least one sample) of the training data (micro-sam's
        training_ui.py:148)."""
        patch_shape = (self.patch_x, self.patch_y)
        kwargs = dict(
            raw_key=self.raw_key, label_key=self.label_key,
            patch_shape=patch_shape,
            with_segmentation_decoder=self.with_segmentation_decoder,
        )
        if self.raw_path_val:
            train_loader = default_sam_loader(
                raw_paths=str(self.raw_path), label_paths=str(self.label_path), **kwargs)
            val_loader = default_sam_loader(
                raw_paths=str(self.raw_path_val), label_paths=str(self.label_path_val),
                **kwargs)
        else:
            from ..training.training import SamLoader
            dataset = default_sam_loader(
                raw_paths=str(self.raw_path), label_paths=str(self.label_path), **kwargs
            ).dataset
            n_val = max(1, int(0.1 * len(dataset)))
            train_ds, val_ds = dataset.split(n_val)
            train_loader, val_loader = SamLoader(train_ds), SamLoader(val_ds)
        return train_loader, val_loader

    def _get_model_type(self):
        """Consolidate the model choice with the configuration preset
        (micro-sam's training_ui.py:187)."""
        suitable = CONFIGURATIONS[self.configuration]["model_type"]
        if self.model_type[:5] == suitable:
            self.model_type = suitable
        else:
            warnings.warn(
                f"You have changed the model type for your chosen configuration "
                f"'{self.configuration}' from '{suitable}' to '{self.model_type}'. "
                "The training may be extremely slow.")

    def _validate_inputs(self):
        missing_raw = not self.raw_path or not os.path.exists(str(self.raw_path))
        missing_label = not self.label_path or not os.path.exists(str(self.label_path))
        if missing_raw or missing_label:
            msg = ""
            if missing_raw:
                msg += "The path to raw data is missing or does not exist. "
            if missing_label:
                msg += "The path to label data is missing or does not exist."
            return generate_message("error", msg)
        return False

    def __call__(self, skip_validate: bool = False):
        self._resolve_model_type()
        if not skip_validate and self._validate_inputs():
            return

        self._get_model_type()
        train_loader, val_loader = self._get_loaders()
        train_sam_for_configuration(
            name=self.name,
            configuration=self.configuration,
            train_loader=train_loader,
            val_loader=val_loader,
            checkpoint_path=self.custom_weights or None,
            with_segmentation_decoder=self.with_segmentation_decoder,
            model_type=self.model_type,
            device=None if self.device == "auto" else self.device,
            n_epochs=self.n_epochs,
        )
        output_path = _export_helper(
            "", self.name, self.output_path or f"{self.name}.pkl", self.model_type,
            self.with_segmentation_decoder, val_loader,
        )
        print(f"Training has finished. The trained model is saved at {output_path}.")
        return output_path
