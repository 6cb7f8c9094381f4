"""The fused serving round on one device (port of ``dab_radio_tpu/parallel``)."""
