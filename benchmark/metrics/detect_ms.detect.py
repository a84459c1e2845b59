"""ms a request in decode and NMS: the driver's host span from a
synchronize before decode_cells to the kept boxes on the host."""


def read(sl):
    spans = sl.driver.detect_spans
    return 1e3 * sum(spans) / len(spans) if spans else None
