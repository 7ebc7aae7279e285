"""Public wrapper for the decode-attention kernel (``csrc/decode_attn.cu``).

:func:`decode_attn` (in ``ops``) launches the CUDA kernel on CUDA tensors and
runs the plain version (``models/attention.py::_decode_core``) off the card.
"""
