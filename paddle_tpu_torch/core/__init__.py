"""The port's framework core: `dtype` (paddle names over torch dtypes, the
JAX package's 32-bit canonicalisation), `place` (places, set_device),
`random` (the counter-based threefry2x32 stream and the Generator),
`tensor` (Tensor, Parameter over torch.autograd) and `selected_rows`."""

from paddle_tpu_torch.core import dtype, place, random  # noqa: F401
from paddle_tpu_torch.core.tensor import Parameter, Tensor

__all__ = ["Parameter", "Tensor"]
