from .hostindex import HostIndex, MAX_TERM_ID, MAX_TERM_LEN  # noqa: F401
from .storage import LogFile  # noqa: F401
