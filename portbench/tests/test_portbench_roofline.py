from portbench import roofline


def test_panel_qr_work_at_the_polish_shape():
    flops, nbytes = roofline.panel_qr_work(64, 1216, 192)
    assert flops == 5_435_817_984
    assert nbytes == 59_817_984
    # The byte bound is the larger: 17.86 µs at 3.35 TB/s.
    assert abs(roofline.bound_s(flops, nbytes) - 59_817_984 / 3.35e12) < 1e-15
    assert flops / roofline.PEAK_TF32_FLOPS < nbytes / roofline.PEAK_BYTES_PER_S
