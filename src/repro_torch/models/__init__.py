"""The LM side of the port: configs (``config``), layers (GQA, MLA, the MLP
and the MoE), the Mamba2 block (``ssm``), the decoder-only LM (``lm``) for
the dense, MoE, ssm and hybrid families, and the enc-dec model
(``encdec``, Whisper).
Each module maps its names to the reference's ``src/repro/models`` in its
docstring; the package exports the enc-dec names the reference's
``models/__init__.py`` exports."""

from .encdec import decode, encdec_loss_fn, encode, init_decoder_cache, init_encdec_params

__all__ = ["decode", "encdec_loss_fn", "encode", "init_decoder_cache", "init_encdec_params"]
