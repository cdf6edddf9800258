"""Core models of the CIM fabric."""
