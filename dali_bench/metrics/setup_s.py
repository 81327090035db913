"""Seconds from process start to the window's opening: loading, drawing
the weights, pinning the host store, calibration, warm-up, and in a first
run the kernel build."""


def read(ctx):
    return ctx["setup_s"]
