"""Index helper shared by the plain PyTorch versions of the kernels."""


def slc(a, axis, sl):
    """``a`` sliced by ``sl`` along ``axis`` (a view)."""
    idx = [slice(None)] * a.dim()
    idx[axis] = sl
    return a[tuple(idx)]
