"""Reader creators (reference: python/paddle/v2/reader/creator.py).

Counterpart of paddle_tpu/reader/creator.py: `np_array`, `text_file`,
and the readers over the native runtime (native.py): `recordio` reads
pickled samples from RecordIO chunk files, `recordio_writer` writes
them, and `cloud_reader` leases chunk tasks from the task master.
"""

import pickle
import time

__all__ = ["np_array", "text_file", "recordio", "recordio_writer",
           "cloud_reader"]


def np_array(x):
    """Yield the rows of an ndarray."""

    def reader():
        for row in x:
            yield row

    return reader


def text_file(path):
    """Yield the lines of a text file, without their newline."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size=None):
    """Yield the pickled samples of RecordIO chunk files (`paths`, a
    list or a comma-separated string), in order (reference: creator.py
    recordio over recordio.reader; here the container is
    native/recordio.cc, each record with its CRC).  Unpickle only chunks
    this program or its workers wrote.  `buf_size` is accepted for the
    reference's signature."""
    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        from ..native import RecordIOReader

        for path in paths:
            rd = RecordIOReader(path)
            try:
                for rec in rd:
                    yield pickle.loads(rec)
            finally:
                rd.close()

    return reader


def recordio_writer(path, samples):
    """Write an iterable of picklable samples as one chunk file."""
    from ..native import RecordIOWriter

    w = RecordIOWriter(path)
    try:
        for s in samples:
            w.write(pickle.dumps(s))
    finally:
        w.close()


def cloud_reader(master_endpoint, pass_num=1):
    """A fault-tolerant distributed reader: lease chunk tasks from the
    master at `master_endpoint` ("host:port"), yield their records, and
    report each task finished, or failed when reading it raised
    (reference: python/paddle/v2/master/client.py next_record; the task
    lease and timeout semantics of go/master/service.go).  Ends after
    `pass_num` passes over the dataset."""
    host, port = master_endpoint.rsplit(":", 1)

    def reader():
        from ..native import MasterClient

        c = MasterClient(host, int(port))
        try:
            passes = 0
            while passes < pass_num:
                tid, chunks = c.get_task()
                if tid == MasterClient.PASS_FINISHED:
                    passes += 1
                    continue
                if tid == MasterClient.NO_TASK:
                    time.sleep(0.05)
                    continue
                try:
                    for sample in recordio(chunks)():
                        yield sample
                except Exception:
                    c.task_failed(tid)
                    raise
                c.task_finished(tid)
        finally:
            c.close()

    return reader
