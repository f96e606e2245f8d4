"""Weight quantization for serving: the port's copies of the JAX
package's weight-only int8 quantizer and its int4 packing
(paddle_tpu/quantization/int8.py) and of the packed int4 weights with
group-wise scales (paddle_tpu/quantization/int4.py), and of the quantized
collectives of tensor-parallel serving (paddle_tpu/quantization/qcomm.py).

The reference wrote these as jnp code, not as Pallas kernels; they port
as plain torch ops. The QAT / PTQ surface of the JAX
`quantization/__init__.py` is ROADMAP.md 'Still to port' item 14.
"""

from paddle_tpu_torch.core.tensor import Parameter, Tensor
from paddle_tpu_torch.ops.registry import OpDef, dispatch
from paddle_tpu_torch.quantization.int4 import (
    INT4_GROUP_SIZE, INT4_QMAX, int4_dequantize, int4_dequantize_reference,
    int4_matmul, int4_quantize, int4_weight_bytes,
)
from paddle_tpu_torch.quantization.int8 import (
    _pack_int4, _unpack_int4, _weight_quantize,
)
from paddle_tpu_torch.quantization.qcomm import (
    allgather_bytes, allreduce_bytes, quantized_allgather,
    quantized_allgather_reference, quantized_allreduce_reference,
    quantized_psum,
)

__all__ = ["INT4_GROUP_SIZE", "INT4_QMAX", "OpDef", "Parameter", "Tensor",
           "allgather_bytes", "allreduce_bytes", "dispatch",
           "int4_dequantize", "int4_dequantize_reference",
           "int4_matmul", "int4_quantize", "int4_weight_bytes",
           "quantized_allgather", "quantized_allgather_reference",
           "quantized_allreduce_reference", "quantized_psum"]
