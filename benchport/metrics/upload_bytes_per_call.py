"""upload_bytes_per_call: bytes the engine copied host to device in the
window (the delta of ``engine.stat_upload_bytes``) per Count call
answered in it; 0 where the row pool holds the whole working set."""


def read(ctx):
    calls = ctx.calls_answered()
    if not calls:
        return None
    return ctx.upload_bytes / calls
