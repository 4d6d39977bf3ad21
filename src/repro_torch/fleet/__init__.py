"""Fleet-scale continuous aggregation: crash-tolerant daemon + producer
client with exactly-once shard ingest (ISSUE 6).  See docs/fleet.md."""
from repro_torch.fleet.client import (CLIENT_FAULT_POINTS, DeliveryReport,  # noqa: F401
                                DirectoryTransport, ShardProducer,
                                SocketTransport, TransportError)
from repro_torch.fleet.daemon import (DAEMON_FAULT_POINTS, FleetDaemon,  # noqa: F401
                                IngestReport, SocketIngest)
from repro_torch.fleet.envelope import (EnvelopeError, EnvelopeHeader,  # noqa: F401
                                  pack_envelope, unpack_envelope,
                                  verify_envelope)
from repro_torch.fleet.journal import JOURNAL_NAME, Journal  # noqa: F401
