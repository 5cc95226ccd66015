"""forward_mfu (.bf16, .f32), %: the window's forwards' operations at the
configuration's peaks (the architecture's work.py `forward_ideal_s`;
RoomNet: bf16 all at 989 TFLOP/s, f32 the TF32-split convs at 495/3, the
rest at 67) over the device's busy time in the traced window (the union of
its operations' intervals, torch.profiler): the whole forward's share of
the chip's peak while the device works. The host's share is
device_idle_pct's."""


def read(r):
    if r.trace is None or not getattr(r, "forwards", 0):
        return None
    busy = r.trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * r.arch.work.forward_ideal_s(r.cfg, r.batch) * r.forwards / busy
