"""The copy has no native library: every caller takes its NumPy path."""


def get_lib():
    return None


def available() -> bool:
    return False


def dequant_recon_native(*args, **kwargs) -> bool:
    """Always False: the caller dequantizes and inverse-transforms in NumPy."""
    return False
