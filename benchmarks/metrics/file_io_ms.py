"""The file API's own reads and writes per request (ms): the phases
`wav_read` (the WAV read and the float clip) and `write` (the v2/v3
file's open and write; v1 has none of its own)."""


def read(run):
    return run.phase_ms(lambda ph: ph["wav_read"] + ph.get("write", 0.0)
                        if "wav_read" in ph else None)
