"""The hand-written CUDA kernels of the port and their wrappers."""
import torch


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise if autograd would have to differentiate through kernel
    ``kernel``: no hand kernel has a backward (nor has the Pallas kernel it
    ports), so a gradient must not stop at one without a word."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"kernel {kernel} has no backward: call it under torch.no_grad() or on "
            "inputs that do not require grad")
