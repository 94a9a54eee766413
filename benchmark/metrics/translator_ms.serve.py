"""Host ms a request inside ``Translator.translate`` and
``Translator.encode`` (chunking, host <-> device copies, the G and E
forwards), over all requests of the traced window."""


def read(ctx):
    if not ctx.get("requests"):
        return None
    return 1e3 * ctx.translator_s / ctx.requests
