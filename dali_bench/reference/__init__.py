"""The plain float32 reference of each model type, found by the
configuration file's ``model_type``: ``reference/<model_type>.py`` gives
``dims(cfg)``, the sizes its weights and its forward pass need, and
``forward_logits``."""
import importlib


def for_config(cfg: dict):
    """The reference module of a configuration file's ``model_type``."""
    return importlib.import_module(f"dali_bench.reference.{cfg['model_type']}")
