from .image import CLIP_MEAN, CLIP_STD, ImageProcessor, device_preprocess  # noqa: F401
from .processing import VisualCLAProcessor  # noqa: F401
