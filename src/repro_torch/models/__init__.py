"""The LM side of the port: configs (``config``), layers (GQA, MLA, the MLP
and the MoE), the Mamba2 block (``ssm``) and the decoder-only LM (``lm``)
for the dense, MoE, ssm and hybrid families.
Each module maps its names to the reference's ``src/repro/models`` in its
docstring."""
