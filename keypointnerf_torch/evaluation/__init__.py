from .evaluator import Evaluator, eval_saved_images, read_png, write_png
from .metrics import bounding_rect, compute_test_metric, psnr, structural_similarity
from .run_eval import run_eval

__all__ = [
    "Evaluator",
    "eval_saved_images",
    "read_png",
    "write_png",
    "bounding_rect",
    "compute_test_metric",
    "psnr",
    "structural_similarity",
    "run_eval",
]
