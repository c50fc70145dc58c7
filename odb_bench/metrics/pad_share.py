"""Share of the device's token slots that held padding over the window:
1 - emitted tokens / device tokens of the loader's accounting."""


def read(ctx):
    device = ctx.accounting.get("device_tokens", 0)
    if not device:
        return None
    return 1.0 - ctx.accounting["emitted_tokens"] / device
