"""Minimal Climate Data Store (CDS) API client over `requests`.

Speaks the current CDS processes API (the same protocol as the cdsapi
package the reference uses, datasets/era5.py:489-507): submit job, poll,
download the result asset.  Credentials come from ``~/.cdsapirc``
(``url:``/``key:`` lines) or the ``CDSAPI_URL``/``CDSAPI_KEY`` environment
variables.

Also provides the file-lock + bounded-thread-pool plumbing that replaces
the reference's SerializableLock / delayed download fan-out
(data.py:43,48-60, era5.py:494-499).

A copy of ``atlite_tpu/io/cds.py``; ``requests`` is imported when a
client is made, never at import.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

logger = logging.getLogger(__name__)

DEFAULT_URL = "https://cds.climate.copernicus.eu/api"


def read_credentials():
    """(url, key) from env or ~/.cdsapirc; raises with instructions if
    neither is configured."""
    url = os.environ.get("CDSAPI_URL")
    key = os.environ.get("CDSAPI_KEY")
    rc = Path(os.environ.get("CDSAPI_RC", Path.home() / ".cdsapirc"))
    if (not url or not key) and rc.exists():
        for line in rc.read_text().splitlines():
            if ":" in line:
                k, v = line.split(":", 1)
                if k.strip() == "url" and not url:
                    url = v.strip()
                elif k.strip() == "key" and not key:
                    key = v.strip()
    if not key:
        raise RuntimeError(
            "No CDS credentials: set CDSAPI_URL/CDSAPI_KEY or create "
            "~/.cdsapirc (url: .../api, key: <token>). For offline use "
            "pass era5_files=... to Cutout/prepare."
        )
    return url or DEFAULT_URL, key


@contextmanager
def file_lock(path):
    """Advisory inter-process lock (the SerializableLock counterpart,
    reference data.py:43): protects concurrent writes of download files."""
    import fcntl

    lock_path = Path(str(path) + ".lock")
    lock_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lock_path, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


class Client:
    """CDS processes-API client: ``retrieve(dataset, request, target)``."""

    def __init__(self, url=None, key=None, sleep=2.0, timeout=60.0,
                 session=None):
        if url is None or key is None:
            cred_url, cred_key = read_credentials()
            url = url or cred_url
            key = key or cred_key
        self.url = url.rstrip("/")
        self.key = key
        self.sleep = sleep
        self.timeout = timeout
        if session is None:
            import requests

            session = requests.Session()
        self.session = session
        self.session.headers.update({"PRIVATE-TOKEN": key})

    def _get(self, path, **kw):
        r = self.session.get(f"{self.url}{path}", timeout=self.timeout, **kw)
        r.raise_for_status()
        return r.json()

    def retrieve(self, dataset, request, target):
        """Submit, poll until complete, download to ``target``."""
        r = self.session.post(
            f"{self.url}/retrieve/v1/processes/{dataset}/execution",
            json={"inputs": request}, timeout=self.timeout,
        )
        r.raise_for_status()
        job = r.json()
        job_id = job.get("jobID") or job.get("id")
        status = job.get("status", "accepted")
        logger.info("CDS job %s submitted (%s)", job_id, dataset)
        # poll only while the job is in a known LIVE state — the
        # processes API can also end as 'dismissed'/'rejected', which
        # previously spun this loop forever
        while status in ("accepted", "queued", "running"):
            time.sleep(self.sleep)
            job = self._get(f"/retrieve/v1/jobs/{job_id}")
            status = job.get("status")
        if status != "successful":
            raise RuntimeError(
                f"CDS job {job_id} ended as {status!r}: {job}")
        results = self._get(f"/retrieve/v1/jobs/{job_id}/results")
        asset = results.get("asset", {}).get("value", {})
        href = asset.get("href")
        if not href:
            raise RuntimeError(f"CDS job {job_id}: no result asset ({results})")
        with self.session.get(href, stream=True, timeout=self.timeout) as resp:
            resp.raise_for_status()
            tmp = Path(str(target) + ".part")
            with open(tmp, "wb") as fh:
                for chunk in resp.iter_content(1 << 20):
                    fh.write(chunk)
            os.replace(tmp, target)
        logger.info("CDS job %s downloaded -> %s", job_id, target)
        return target


def map_requests(fn, requests, concurrent=False, max_workers=4):
    """Run ``fn`` over request dicts, optionally concurrently (the
    reference's concurrent_requests/delayed fan-out, data.py:185-188)."""
    if concurrent and len(requests) > 1:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            return list(pool.map(fn, requests))
    return [fn(r) for r in requests]
