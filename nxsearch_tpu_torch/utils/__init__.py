from .validate import str_isalnumdu  # noqa: F401
from .log import get_logger  # noqa: F401
