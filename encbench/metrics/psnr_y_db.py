"""Luma PSNR of the shown reconstructions against the source over the
clip's first ``fixed_frames`` frames, from their pooled squared error."""


def read(obs):
    return obs.fixed_psnr_y_db
