"""Device: share of the traced window in which no device operation ran."""


def read(obs):
    return obs.device_idle_pct()
