"""Scaling over many chains and devices (counterpart of
``rxinfer_tpu/parallel``).  Ported: ``filtering`` on one device."""
