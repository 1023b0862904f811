"""Training in more than one process (counterpart of
synthesis_in_style_tpu/parallel): `parallel.distributed`."""
