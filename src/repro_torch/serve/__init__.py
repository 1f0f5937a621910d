from repro_torch.serve.engine import ServingEngine, make_prefill, make_serve_step  # noqa: F401
from repro_torch.serve.paged_cache import TRASH_PAGE, PageAllocator, pages_for  # noqa: F401
from repro_torch.serve.scheduler import (ContinuousBatchingEngine, Request,  # noqa: F401
                                         make_paged_prefill, make_paged_serve_step)
