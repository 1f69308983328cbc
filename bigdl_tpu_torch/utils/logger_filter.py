"""Logging policy (counterpart of ``bigdl_tpu/utils/logger_filter.py``;
BigDL's ``utils/LoggerFilter.scala``): the port's progress logger
(``bigdl_tpu_torch``) stays on the console, and the libraries' INFO
chatter goes to a file.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Optional, Sequence

#: the libraries whose INFO records go to the file
_DEFAULT_NOISY = ("PIL", "urllib3")
_configured_path: Optional[str] = None


def redirect_logs(log_file: Optional[str] = None,
                  noisy: Sequence[str] = _DEFAULT_NOISY,
                  console_level: int = logging.INFO) -> None:
    """reference ``redirect_logs``: ``noisy``'s records go to ``bigdl.log``
    under ``$BIGDL_LOG_DIR`` (default the system's temporary directory, not
    the working directory), the ``bigdl_tpu_torch`` logger gets a console
    handler at ``console_level``. Calling it again with the same (or no)
    file does nothing; another ``log_file`` re-routes."""
    global _configured_path
    log_path = log_file or os.path.join(
        os.environ.get("BIGDL_LOG_DIR", tempfile.gettempdir()), "bigdl.log")
    if _configured_path == log_path:
        return
    _configured_path = log_path
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S")
    try:
        file_handler: Optional[logging.Handler] = logging.FileHandler(log_path)
        file_handler.setFormatter(fmt)
    except OSError:
        file_handler = None   # an unwritable directory: the chatter is dropped

    for name in noisy:
        lg = logging.getLogger(name)
        for h in lg.handlers:   # close the handlers a re-route replaces
            h.close()
        lg.handlers = [file_handler] if file_handler else []
        lg.propagate = False
        lg.setLevel(logging.INFO)

    port = logging.getLogger("bigdl_tpu_torch")
    if not port.handlers:
        console = logging.StreamHandler()
        console.setFormatter(fmt)
        port.addHandler(console)
    port.setLevel(console_level)


def reset() -> None:
    """Forget the configured file, so the next ``redirect_logs`` routes
    again."""
    global _configured_path
    _configured_path = None
