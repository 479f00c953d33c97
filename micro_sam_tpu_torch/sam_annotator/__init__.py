"""Interactive annotation tools (counterpart of ``micro_sam_tpu/sam_annotator``):
the napari annotators over the port's predictor, and their headless core.

The computational core (state, layers to prompts, the interactive nd
segmentation and tracking loops, commits) needs no napari; the widgets run
on the form layer of ``_compat`` (Qt under napari, plain Python headless, as
with ``_test_util.FakeViewer``); opening a real viewer without napari raises.
The entry points load the model on the card unless given ``device="cpu"``.
"""
from .annotator_2d import annotator_2d
from .annotator_3d import annotator_3d
from .annotator_tracking import annotator_tracking
from .image_series_annotator import image_series_annotator, image_folder_annotator
from ._state import AnnotatorState
