"""% of the latent lookup's points (B x N) that the gather kernel took (the
program's latent_kernel_points and latent_plain_points counters); None
where the program counts neither."""

from benchmark import program_spans


def read(sl):
    kernel = program_spans.counter(sl, "latent_kernel_points")
    plain = program_spans.counter(sl, "latent_plain_points")
    if kernel is None or not kernel + plain:
        return None
    return 100.0 * kernel / (kernel + plain)
