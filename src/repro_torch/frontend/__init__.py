"""Router-side front end of the port: the admission queue
(priority/fairness classes, bounded depth) that the serving loop uses to
absorb bursts instead of rejecting them.  The HTTP/SSE server, its
gateway, the token pipeline and the tokenizer come with the slice that
ports the rest of the front end."""
from repro_torch.frontend.admission import (AdmissionConfig, AdmissionQueue,
                                            PRIORITY_CLASSES)

__all__ = ["AdmissionConfig", "AdmissionQueue", "PRIORITY_CLASSES"]
