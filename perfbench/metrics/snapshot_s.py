"""Seconds of the set-up's device snapshot build
(index/device.DeviceIndex: CSR, pack, dense rows, impact-prefix
region, upload), on the host clock, ended by a synchronise."""


def read(run):
    return run.setup.get("snapshot_s") or None
