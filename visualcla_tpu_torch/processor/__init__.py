from .image import CLIP_MEAN, CLIP_STD, ImageProcessor  # noqa: F401
from .processing import VisualCLAProcessor  # noqa: F401
