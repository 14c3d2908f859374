"""Milliseconds the card was busy (any kernel, memset or copy) per API
call of the traced window: the device's share of a call, which does not
move with the host's speed."""


def read(obs):
    dev = obs["device"]
    if not dev or not obs["calls"]:
        return None
    return dev["busy_s"] / len(obs["calls"]) * 1e3
