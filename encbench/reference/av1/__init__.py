"""Frozen copy of rav1e_tpu_torch's decoder closure (see ``decoder``)."""
