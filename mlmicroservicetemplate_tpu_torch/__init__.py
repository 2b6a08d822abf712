"""PyTorch/CUDA port of the inference microservice template.

``python -m mlmicroservicetemplate_tpu_torch`` serves (``serve.py``);
``register_model`` plugs a model of your own into the same stack.
Importing the package loads nothing else: the registry (and torch) come
with the first ``register_model`` call.
"""


def register_model(name, builder):
    """Template extension point: see ``models.registry.register_model``."""
    from .models.registry import register_model as _register

    _register(name, builder)
