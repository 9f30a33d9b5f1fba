"""Device kernels of the profiled slice (copies, fills and the bracketing
spin kernels left out) over the images the slice served or trained on."""


def read(record: dict, name: str):
    sl, images = record.get("slice"), record.get("slice_images")
    if sl is None or not images:
        return None
    return len(sl.kernels()) / images
