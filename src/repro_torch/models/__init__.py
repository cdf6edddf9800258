"""The LM side of the port: configs (``config``), layers, the Mamba2 block
(``ssm``) and the decoder-only LM (``lm``) for the ssm and hybrid families.
Each module maps its names to the reference's ``src/repro/models`` in its
docstring."""
