"""What one request is, one module per kind, found by the configuration's
"entry": `entries/<entry>.py` defines a class `Entry`, the call into the
codec that a user of that deployment makes:

- `Entry(config, files, workdir, device)` prepares the pool's inputs
  (set-up);
- `request(i)` sends pool file i and keeps its latest answer;
- `answer(i)` reads that answer back as a `reference.compare.Answer`;
- `Entry.reference(cfg, samples, device, lowp=False)`, the plain
  reference's answer for the same input by the path this call takes;
- `Entry.kernel_calls(cfg, n_samples)`, the kernel calls one request of
  that length makes, with the counts their work depends on (`calls.py`).

A new kind of request is a new module here; nothing else changes.
"""
