from .objectid import ObjectId, InvalidId  # noqa: F401
from .documents import (  # noqa: F401
    Database,
    Collection,
    DuplicateKeyError,
    InsertOne,
    UpdateOne,
    UpdateMany,
    DeleteOne,
    DeleteMany,
    ReplaceOne,
)
from .gridfs import GridFS, NoFile  # noqa: F401
from .client import Datastore, get_datastore, reset_datastores  # noqa: F401
from .remote import RemoteDatabase  # noqa: F401
from .server import StoreServer  # noqa: F401
from .indexes import init_db, seed_templates  # noqa: F401
