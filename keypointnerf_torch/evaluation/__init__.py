from .evaluator import Evaluator, eval_saved_images, read_png, write_png
from .meshing import extract_mesh, marching_tetrahedra, save_obj
from .metrics import bounding_rect, compute_test_metric, psnr, structural_similarity
from .run_eval import run_eval

__all__ = [
    "Evaluator",
    "eval_saved_images",
    "read_png",
    "write_png",
    "extract_mesh",
    "marching_tetrahedra",
    "save_obj",
    "bounding_rect",
    "compute_test_metric",
    "psnr",
    "structural_similarity",
    "run_eval",
]
